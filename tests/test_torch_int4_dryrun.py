"""The dry-run's ``--weight-quant int4`` and ``--remat selective`` cells of
qwen3-1.7b on the single production mesh, against the JAX package's layout
(`test_torch_dryrun_specs._reference_layout` on an `AbstractMesh`: the plan
sees the quantized bytes, as the reference's `run_cell` feeds it).

- Plan fields and bytes per device equal the reference's: an int4 payload
  is stored packed (two values a byte), which is the reference's 0.5 B a
  value; selective remat changes no state.
- The int4 `decode_32k` cell runs end to end through the CLI (256 fake
  ranks) and is `ok`.
- The int4 `train_4k` cell errs in both packages: weight-only quantization
  serves, and a train step differentiates every parameter (the reference's
  `value_and_grad` refuses its int4 leaves; the port's `init_train_state`
  refuses by name).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from test_torch_dryrun_specs import FIELDS, _reference_layout
from repro_torch.launch import dryrun as PD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape,knob", [
    ("decode_32k", dict(weight_quant="int4")),
    ("prefill_32k", dict(weight_quant="int4")),
    ("decode_32k", dict(remat="selective")),
    ("train_4k", dict(remat="selective")),
], ids=str)
def test_plan_and_bytes_equal_the_references(shape, knob):
    lay = PD.layout_cell("qwen3-1.7b", shape, "single", **knob)
    want = _reference_layout("qwen3-1.7b", shape, "single", **knob)
    got = {k: lay.result[k] for k in FIELDS if k in lay.result}
    assert got == want
    assert lay.cfg.weight_quant == knob.get("weight_quant", "none")
    if "weight_quant" in knob:
        assert lay.result["bytes_per_param"] == 0.5
        plain = PD.layout_cell("qwen3-1.7b", shape, "single")
        assert got["params_bytes_per_device"] < \
            0.5 * plain.result["params_bytes_per_device"]


def test_int4_train_cell_errs_as_the_references():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.models.model_zoo import build_model
    from repro.optim.adamw import AdamWConfig
    from repro.optim.schedule import constant
    from repro.train.state import init_train_state, make_train_step
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              weight_quant="int4")
    m = build_model(cfg)
    st = jax.eval_shape(lambda: init_train_state(
        m, jax.random.PRNGKey(0), AdamWConfig(), None))
    toks = jax.ShapeDtypeStruct((2, 16), jnp.int32)
    step = make_train_step(m, AdamWConfig(), constant(1e-4),
                           instrument=False)
    with pytest.raises(TypeError, match="int4"):
        jax.eval_shape(step, st, {"tokens": toks, "labels": toks})
    with pytest.raises(NotImplementedError, match="integer payload"):
        PD.layout_cell("qwen3-1.7b", "train_4k", "single",
                       weight_quant="int4")


def test_int4_decode_cell_end_to_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "single",
         "--weight-quant", "int4", "--device", "cpu", "--out",
         str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "qwen3-1.7b__decode_32k__single.json") as f:
        res = json.load(f)
    assert res["status"] == "ok", res.get("traceback", "")[-2000:]
    assert res["weight_quant"] == "int4"
    want = _reference_layout("qwen3-1.7b", "decode_32k", "single",
                             weight_quant="int4")
    assert res["params_bytes_per_device"] == \
        want["params_bytes_per_device"]
    assert res["flops"] > 0 and res["trace_flops_global"] > 0
