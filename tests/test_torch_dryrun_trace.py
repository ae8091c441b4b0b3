"""The dry-run's FLOPs and collectives against the JAX package's, on the
CPU.  Op counts are IR-specific and are not compared; matrix-product FLOPs
are (the unit-of-work rule, ROADMAP).

- For reduced configs of every family (dense, MoE, SSM, hybrid, enc-dec,
  VLM), the matmul FLOPs of each traced block and of the whole step (train
  with `remat` none and full, prefill, decode) equal the reference's
  `dot_general` FLOPs (`tests/test_torch_core._jax_dot_flops`, contracting
  products only: an einsum's elementwise products are `mul` in ATen) on the
  same shapes.  The attention runs in chunks of 8 over 32 positions, so
  the chunked schedule's 4 x 4 blocks are all counted, as the reference's
  unrolled q loop counts them.
- The dry-run prices a train step part by part (`TrainStep.start`,
  `microbatch` times `accumulate`, `finish`): the sum equals the unrolled
  step's recorded cost exactly at `microbatch` 2 and 4, and the recorded
  cost of a step equals `trace_cost`'s (make_fx) in FLOPs.
- On a fake group of 4 ranks ((data 2, model 2), tp 2), a dense layer's
  forward under the serving plan issues the 2 all-reduces that
  `roofline._tp_ar_per_layer` assumes (the attention's output projection
  and the MLP's, each a row-parallel product); the attention core runs on
  each rank's rows and heads and issues none.
- One full-width cell (qwen3-1.7b `decode_32k`, single mesh: 256 fake ranks)
  runs end to end through the CLI in a process of its own.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.hlo_analysis import ProgramRecorder, collective_stats
from repro_torch.core.unit_of_work import matmul_flops, trace_cost, \
    trace_graph
from repro_torch.launch import dryrun as PD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"qwen3-1.7b": {}, "olmoe-1b-7b": {}, "mamba2-780m": {},
            "zamba2-1.2b": dict(n_layers=5), "whisper-tiny": {},
            "internvl2-76b": {}}
SEQ, CHUNK = 32, 8


def _configs(arch, remat="full"):
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro_torch.configs import get_config, reduced
    kw = FAMILIES[arch]
    over = dict(attention_impl="chunked", ssm_impl="chunked",
                attn_chunk=CHUNK, remat=remat)
    return (dataclasses.replace(jreduced(jget(arch), **kw), **over),
            dataclasses.replace(reduced(get_config(arch), **kw), **over))


def _dot(fn, *args):
    import jax
    from test_torch_core import _jax_dot_flops
    return _jax_dot_flops(jax.make_jaxpr(fn)(*args), contracting_only=True)


def _recorded_matmul(fn, *args):
    rec = ProgramRecorder()
    with torch.no_grad(), rec:
        out = fn(*args)
    return matmul_flops(rec.ops), out


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_block_matmul_flops_equal_the_references(arch, monkeypatch):
    from repro.configs.base import ShapeConfig as JShape
    import repro.core.blocks_lm as JB
    from repro.models.model_zoo import build_model as jbuild
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import blocks_lm as PB
    from repro_torch.models.model_zoo import build_model
    jcfg, pcfg = _configs(arch)
    for kind, batch in (("prefill", 2), ("decode", 3)):
        jflops = []
        real = JB.trace_cost

        def spy(fn, *args, **kw):
            jflops.append(_dot(fn, *args))
            return real(fn, *args, **kw)
        monkeypatch.setattr(JB, "trace_cost", spy)
        jtab = JB.build_block_table(jbuild(jcfg), JShape("x", kind, SEQ,
                                                        batch), train=False)
        monkeypatch.setattr(JB, "trace_cost", real)
        pmodel = build_model(pcfg, device="meta")
        shape = ShapeConfig("x", kind, SEQ, batch)
        pflops = {name: matmul_flops(trace_graph(fn, *args))
                  for name, fn, args in PB.block_functions(pmodel, shape)}
        assert set(pflops) == set(jtab.names) - {
            n for n in jtab.names if n.startswith("expert_tok_")
            or n == "dropped_tokens"}
        assert sorted(pflops.values()) == sorted(jflops), (kind, pflops,
                                                            jflops)
        assert max(pflops.values()) > 0


def _jax_step_flops(jcfg, kind, batch, microbatch=1):
    import jax
    from repro.configs.base import ShapeConfig as JShape
    from repro.models.model_zoo import build_model as jbuild
    from repro.optim.adamw import AdamWConfig
    from repro.optim.schedule import constant
    from repro.train.state import init_train_state, make_train_step
    model = jbuild(jcfg)
    shape = JShape("x", kind, SEQ, batch)
    if kind == "train":
        step = make_train_step(model, AdamWConfig(), constant(1e-4),
                               microbatch=microbatch, instrument=False)
        state = jax.eval_shape(lambda: init_train_state(
            model, jax.random.PRNGKey(0), AdamWConfig(), None))
        return _dot(step, state, model.input_specs(shape))
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: model.init_cache(batch, SEQ))
    if kind == "prefill":
        return _dot(model.prefill, params, model.input_specs(shape), cache)
    return _dot(model.decode_step, params, model.input_specs(shape)["token"],
                cache)


def _port_step(pcfg, kind, batch, microbatch=1):
    """(model, meta state or params, batch, cache) of the port's step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.base import dtype_of
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import constant
    from repro_torch.train.state import init_train_state, make_train_step
    model = build_model(pcfg, device="meta")
    shape = ShapeConfig("x", kind, SEQ, batch)
    params = PD._spec_struct(model.specs(), dtype_of(pcfg.param_dtype))
    inputs = model.input_specs(shape)
    if kind == "train":
        state = init_train_state(model, params, AdamWConfig(), None)
        step = make_train_step(model, AdamWConfig(), constant(1e-4),
                               microbatch=microbatch, instrument=False)
        return step, state, inputs
    return model, params, inputs, model.cache_specs_struct(shape)


def _port_train_parts(step, state, inputs, microbatch, measure):
    """The dry-run's part-by-part sum of ``measure`` (a function's (value,
    outputs)) over the train step."""
    parts = []

    def run(fn, args, reps):
        value, out = measure(fn, *args)
        parts.append(value.scale(reps) if hasattr(value, "scale")
                     else value * reps)
        return out
    PD._train_parts(step, state, inputs, microbatch, run)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _ssd_backward_gap(pcfg, batch):
    """Matmul FLOPs that the reference's SSD backward has and the port's
    has not, on one layer's shapes: the reference's three-operand einsums
    split into an elementwise `dot_general` and a contracting one, and the
    transpose of the elementwise one contracts (a `dot_general` in the
    jaxpr, `mul` then `sum` in ATen).  Measured on the SSD alone, both
    packages, with gradients for all five inputs, as in the step."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as JS
    from repro_torch.models import ssm as PS
    from test_torch_core import _jax_dot_flops
    d_inner, nh = PS.ssm_dims(pcfg)
    hp, n, chunk = pcfg.ssm.head_dim, pcfg.ssm.d_state, pcfg.ssm.chunk
    shapes = [(batch, SEQ, nh, hp), (batch, SEQ, nh), (nh,), (batch, SEQ, n),
              (batch, SEQ, n)]
    ref = jax.grad(lambda *a: JS.ssd_chunked(*a, chunk)[0].sum(),
                   argnums=(0, 1, 2, 3, 4))
    want = _jax_dot_flops(jax.make_jaxpr(ref)(*(
        jax.ShapeDtypeStruct(sh, jnp.float32) for sh in shapes)),
        contracting_only=True)

    def port(*a):
        with torch.enable_grad():
            return torch.autograd.grad(
                PS.ssd_chunked(*a, chunk)[0].sum(), a)
    got = matmul_flops(trace_graph(port, *(
        torch.empty(sh, device="meta", requires_grad=True) for sh in shapes)))
    return want - got


@pytest.mark.parametrize("arch", list(FAMILIES))
@pytest.mark.parametrize("kind", ["train-none", "train-full", "prefill",
                                  "decode"])
def test_step_matmul_flops_equal_the_references(arch, kind):
    """Equal, but for the SSM families' train step: there the reference
    also counts its SSD backward's transposed elementwise products
    (`_ssd_backward_gap`), once for each Mamba2 layer, and nothing else
    differs."""
    kind, _, remat = kind.partition("-")
    jcfg, pcfg = _configs(arch, remat or "full")
    batch = 4 if kind == "train" else 2
    want = _jax_step_flops(jcfg, kind, batch)
    if kind == "train":
        step, state, inputs = _port_step(pcfg, kind, batch)
        got = _port_train_parts(step, state, inputs, 1, _recorded_matmul)
        if pcfg.family in ("ssm", "hybrid"):
            gap = _ssd_backward_gap(pcfg, batch)
            assert gap > 0
            got += pcfg.n_layers * gap
    else:
        model, params, inputs, cache = _port_step(pcfg, kind, batch)
        fn = model.prefill if kind == "prefill" else model.decode_step
        got = _recorded_matmul(
            fn, params, inputs if kind == "prefill" else inputs["token"],
            cache)[0]
    assert got == want and got > 0, (got, want)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b"])
@pytest.mark.parametrize("microbatch", [2, 4])
def test_microbatch_sum_equals_the_unrolled_step(arch, microbatch):
    _, pcfg = _configs(arch)
    step, state, inputs = _port_step(pcfg, "train", 8, microbatch)
    parts = _port_train_parts(step, state, inputs, microbatch,
                              PD.recorded_cost)
    unrolled, aux = PD.recorded_cost(lambda s, b: step(s, b)[2], state,
                                     inputs)
    assert (parts.ops, parts.flops) == (unrolled.ops, unrolled.flops)
    # bytes: the sum counts every slice as the first, whose aux sums start
    # from the Python 0 (no operand bytes); a later slice reads the running
    # sum's tensor too
    aux_bytes = sum(v.numel() * v.element_size() for v in aux.values())
    assert unrolled.bytes - parts.bytes == (microbatch - 1) * aux_bytes
    # the reference scans the microbatches: the same products
    jcfg, _ = _configs(arch)
    got = _recorded_matmul(lambda s, b: step(s, b)[1], state, inputs)[0]
    if pcfg.family in ("ssm", "hybrid"):
        got += pcfg.n_layers * microbatch * _ssd_backward_gap(
            pcfg, 8 // microbatch)
    assert got == _jax_step_flops(jcfg, "train", 8, microbatch)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m"])
def test_recorded_cost_equals_trace_cost_in_flops(arch):
    _, pcfg = _configs(arch)
    step, state, inputs = _port_step(pcfg, "train", 4, 2)
    fn = lambda s, b: step(s, b)[1]      # noqa: E731
    recorded, _ = PD.recorded_cost(fn, state, inputs)
    traced = trace_cost(fn, state, inputs)
    assert recorded.flops == traced.flops
    assert matmul_flops(trace_graph(fn, state, inputs)) == \
        _recorded_matmul(fn, state, inputs)[0]


def _dense_layer_collectives(rank, world, init_file):
    """A dense layer's forward under the serving plan on a fake group of 4
    ranks ((data 2, model 2)): the per-rank program's collectives, and
    those of the attention core alone."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import (logical_rules,
                                                  params_shardings,
                                                  placements, sharded_region,
                                                  use_rules)
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    plan = logical_rules(mesh, mode="serve")
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              attention_impl="chunked", n_layers=1)
    out = {}
    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(plan):
        model = build_model(cfg, plan, device="cpu")
        lp = T.layer_specs(cfg, model.dims)
        params = PD._fake_tree(PD._spec_struct(lp, torch.float32),
                               params_shardings(mesh, plan, L.axes_tree(lp)),
                               "cpu")
        x = PD._fake_dtensor(torch.empty((4, 16, cfg.d_model),
                                         device="meta"),
                             (mesh, placements(mesh, plan.spec(
                                 ("batch", "seq", "act_embed")))), "cpu")
        pos = torch.arange(16, dtype=torch.int32)[None].expand(4, 16)
        calls = {}
        real_attend = A.attend

        def attend(*args, **kw):
            n = len(rec.ops)
            y = real_attend(*args, **kw)
            calls["attend"] = (n, len(rec.ops))
            return y
        A.attend = attend
        rec = ProgramRecorder()
        try:
            with rec, sharded_region(params):
                T.dense_layer(params, cfg, model.dims, x, pos, -1)
        finally:
            A.attend = real_attend
    lo, hi = calls["attend"]
    out["layer"] = collective_stats(rec.ops)
    out["attention_core"] = collective_stats(rec.ops[lo:hi])
    return out


def test_dense_layer_all_reduces_are_the_rooflines():
    from _torch_port import run_ranks
    from repro_torch.launch.roofline import _tp_ar_per_layer
    (res,) = run_ranks(_dense_layer_collectives, 1, timeout=180)
    assert res["layer"]["all-reduce"]["count"] == \
        _tp_ar_per_layer({"family": "dense"}) == 2
    assert res["layer"]["all-reduce"]["bytes"] > 0
    assert all(v["count"] == 0 for v in res["attention_core"].values())


def test_full_width_decode_cell_end_to_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "single",
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "qwen3-1.7b__decode_32k__single.json") as f:
        cell = json.load(f)
    assert cell["status"] == "ok" and cell["devices"] == 256
    assert cell["params_bytes_per_device"] == 435505152
    assert cell["attention_impl"] == cell["ssm_impl"] == "chunked"
    assert cell["kernel_launches"] == {"flash_attention": 0,
                                       "flash_decode": 0, "ssd_intra": 0,
                                       "grouped_mlp": 0, "mla_decode": 0}
    assert 0 < cell["flops"] < cell["trace_flops_global"]
    assert cell["collectives"]["all-reduce"]["count"] > 0
    assert set(cell["collectives"]) == {"all-reduce", "all-gather",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"}
