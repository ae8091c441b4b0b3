"""The port's enc-dec family (whisper-tiny, reduced: 2 encoder and 2 decoder
layers, 16 frames, f32) against the JAX package's on converted parameters
and numpy inputs from a seed: the encoder, the training forward, the loss
and its gradients, prefill and decode steps with unequal row lengths, the
serve engine's greedy tokens, the block table, the refusal of an int8 cache
and the trainer's frames.  The JAX side runs ``attention_impl="pallas"``
(interpret mode) where no gradient is taken and ``"chunked"`` where one is;
the port ``"cuda"`` (on CPU tensors the kernels' plain versions) and
``"chunked"``.  Tolerance 2e-4 of max(1, the largest magnitude of the JAX
value), the reference's own cross-implementation tolerance
(tests/test_models.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import model_pair, to_np
from test_torch_train import _flat
from repro.configs.base import ShapeConfig as JShape
from repro.core import blocks_lm as JB
from repro.models import encdec as JED
from repro.serve import ServeEngine as JEngine
from repro.serve import SyntheticRequests as JRequests
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import blocks_lm as PB
from repro_torch.models import encdec as PED
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine, SyntheticRequests
from repro_torch.train import Trainer

ARCH = "whisper-tiny"
TOL = 2e-4


def _rel(got, want) -> float:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.n_frames, cfg.d_model)
                                 ).astype(np.float32)
    return toks, frames


def test_encode_matches(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    _, frames = _inputs(pcfg, 2, 4)
    want = JED.encode(jp, jcfg, jm.dims, jnp.asarray(frames))
    got = PED.encode(pp, pcfg, pm.dims, torch.from_numpy(frames))
    assert _rel(got, want) <= TOL


def test_layernorm_matches():
    x = np.random.default_rng(3).standard_normal((3, 5, 24)
                                                ).astype(np.float32) * 4
    p = {"scale": np.linspace(0.5, 1.5, 24, dtype=np.float32),
         "bias": np.linspace(-1, 1, 24, dtype=np.float32)}
    want = JED.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = PED.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
    bf = PED.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).bfloat16())
    assert bf.dtype == torch.bfloat16


def test_forward_logits(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    toks, frames = _inputs(pcfg, 2, 12)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)})
    got, aux = pm.forward(pp, {"tokens": torch.from_numpy(toks),
                               "frames": torch.from_numpy(frames)})
    assert aux == {}
    assert _rel(got, want) <= TOL


def test_loss_and_gradients(pair):
    """Loss and every leaf's gradient on the chunked attention (the training
    path of both packages)."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    from repro.models.model_zoo import build_model as jbuild
    jm = jbuild(dataclasses.replace(jcfg, attention_impl="chunked",
                                    attn_chunk=8))
    pm = build_model(dataclasses.replace(pcfg, attention_impl="chunked",
                                         attn_chunk=8), device="cpu")
    toks, frames = _inputs(pcfg, 2, 12, seed=4)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "frames": jnp.asarray(frames)}
    jloss, jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(jp)
    params = L.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    pb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    loss, aux = pm.loss(params, pb)
    flat = _flat(params)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    assert abs(loss.item() - float(jloss)) <= TOL * max(1.0, abs(float(jloss)))
    assert "nll_mean" in aux
    want = _flat(jgrad)
    assert sorted(grads) == sorted(want)
    for key, w in want.items():
        assert _rel(grads[key], w) <= TOL, key


def test_prefill_and_decode_steps(pair):
    """Prefill fills the self and cross caches; three decode steps with one
    row far behind and one idle row past the cache (its write dropped)."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    b, s, max_seq = 3, 10, 32
    toks, frames = _inputs(pcfg, b, s, seed=1)
    jc = jm.init_cache(b, max_seq)
    pc = pm.init_cache(b, max_seq)
    assert set(pc) == set(jc) == {"length", "k", "v", "cross_k", "cross_v"}
    for key in jc:
        assert tuple(pc[key].shape) == tuple(jc[key].shape), key
    want, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)}, jc)
    got, pc2, _ = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                                  "frames": torch.from_numpy(frames)}, pc)
    assert pc2 is pc                              # updated in place
    assert _rel(got, want) <= TOL
    for key in jc:
        assert _rel(pc[key], jc[key]) <= TOL, key

    lens = np.asarray([s, 4, max_seq + 2], np.int32)
    jc["length"] = jnp.asarray(lens)
    pc["length"].copy_(torch.from_numpy(lens))
    rng = np.random.default_rng(2)
    for step in range(3):
        tok = rng.integers(0, pcfg.vocab_size, size=(b, 1)).astype(np.int32)
        want, jc, _ = jm.decode_step(jp, jnp.asarray(tok), jc)
        got, pc, _ = pm.decode_step(pp, torch.from_numpy(tok), pc)
        assert _rel(got, want) <= TOL, step
        np.testing.assert_array_equal(to_np(pc["length"]), lens + step + 1)
        for key in jc:
            assert _rel(pc[key], jc[key]) <= TOL, (step, key)


def test_engine_matches_the_jax_engine(pair):
    """Greedy tokens request by request, with the engine's zero frames."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    kw = dict(batch=3, max_seq=48, prefill_len=10, instrument=False)
    jeng = JEngine(jcfg, **kw)
    peng = ServeEngine(pcfg, device="cpu", **kw)
    assert tuple(peng.stub_inputs["frames"].shape) == (1, pcfg.n_frames,
                                                       pcfg.d_model)
    jgen = JRequests(jcfg.vocab_size, prompt_len=8, mean_new=6, seed=0)
    pgen = SyntheticRequests(pcfg.vocab_size, prompt_len=8, mean_new=6,
                             seed=0)
    jstats = jeng.run(jp, [jgen.request(i) for i in range(5)])
    pstats = peng.run(pp, [pgen.request(i) for i in range(5)])
    assert {r.req_id: r.output for r in peng.done} == \
        {r.req_id: r.output for r in jeng.done}
    assert peng.kinds_log == jeng.kinds_log
    assert pstats["tokens"] == jstats["tokens"]


@pytest.mark.parametrize("kind,seq,batch", [("prefill", 12, 1),
                                            ("decode", 32, 3),
                                            ("train", 16, 2)])
def test_block_table_matches_the_reference(kind, seq, batch):
    """The reference's enc-dec block names and step program (embed, enc_layer
    x n_enc_layers, dec_layer x n_layers, head)."""
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models.model_zoo import build_model as jbuild
    jmodel = jbuild(jreduced(jget(ARCH)))
    pmodel = build_model(reduced(get_config(ARCH)), device="cpu")
    jtab = JB.build_block_table(jmodel, JShape("x", kind, seq, batch),
                                unit="flops")
    ptab = PB.build_block_table(pmodel, ShapeConfig("x", kind, seq, batch),
                                unit="flops")
    assert ptab.names == jtab.names == ["embed", "enc_layer", "dec_layer",
                                        "head"]
    prog = [(s.pattern, s.repeat) for s in ptab.program]
    assert prog == [(s.pattern, s.repeat) for s in jtab.program]
    cfg = pmodel.cfg
    assert prog == [
        ((0,), 1), ((1,), cfg.n_enc_layers), ((2,), cfg.n_layers), ((3,), 1)]
    for block in ptab.blocks:
        assert block.cost_flops > 0 or block.name == "embed"


def test_int8_cache_is_refused():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), cache_quant="int8")
    with pytest.raises(NotImplementedError, match="no scale"):
        build_model(cfg, device="cpu")


def test_trainer_feeds_frames_and_launches_no_kernel():
    """The default corpus carries frames, as the reference's; two steps on
    the chunked attention give finite losses."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              attention_impl="chunked", ssm_impl="chunked")
    tr = Trainer(cfg, seq_len=16, batch=2, device="cpu", instrument=False)
    b = tr.data.batch_at(0)
    assert b["frames"].shape == (2, cfg.n_frames, cfg.d_model)
    tr.run(2)
    rows = list(tr.metrics_history)
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
