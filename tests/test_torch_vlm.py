"""The port's VLM family (internvl2-76b, reduced: 2 layers, 4 patch
positions, f32) against the JAX package's on converted parameters and
non-zero patch embeddings made with numpy from a seed: the patch projection
in the embeddings (prompt longer and shorter than the patches), the forward,
the loss and its gradients, prefill and decode steps, the serve engine's
greedy tokens (zero patches, as both engines pass) and the block table.  The
JAX side runs ``attention_impl="pallas"`` (interpret mode) where no gradient
is taken and ``"chunked"`` where one is; the port ``"cuda"`` (on CPU tensors
the kernels' plain versions) and ``"chunked"``.  Tolerance 2e-4 of max(1,
the largest magnitude of the JAX value), the reference's own
cross-implementation tolerance (tests/test_models.py)."""
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
from repro.models import transformer as JT
from repro.serve import ServeEngine as JEngine
from repro.serve import SyntheticRequests as JRequests
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import blocks_lm as PB
from repro_torch.models import layers as L
from repro_torch.models import transformer as PT
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine, SyntheticRequests
from repro_torch.train import Trainer

ARCH = "internvl2-76b"
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
    patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)
                                  ).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("s", [10, 3])
def test_patches_replace_the_first_positions(pair, s):
    """A prompt longer than the patches keeps its later tokens; a shorter
    one is all patches."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    toks, patches = _inputs(pcfg, 2, s)
    want = JT.embed_tokens(jp, jcfg, jm.dims, jnp.asarray(toks),
                           jnp.asarray(patches))
    got = PT.embed_tokens(pp, pcfg, pm.dims, torch.from_numpy(toks),
                          torch.from_numpy(patches))
    assert got.shape[1] == s
    assert _rel(got, want) <= TOL
    plain = PT.embed_tokens(pp, pcfg, pm.dims, torch.from_numpy(toks))
    n = min(s, pcfg.n_patches)
    assert not torch.allclose(got[:, :n], plain[:, :n])
    assert torch.equal(got[:, n:], plain[:, n:])


def test_forward_logits(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    toks, patches = _inputs(pcfg, 2, 12)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                              "patches": jnp.asarray(patches)})
    got, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks),
                             "patches": torch.from_numpy(patches)})
    assert _rel(got, want) <= TOL


def test_loss_and_gradients(pair):
    """Loss and every leaf's gradient (``patch_proj``'s included) on the
    chunked attention (the training path of both packages)."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    from repro.models.model_zoo import build_model as jbuild
    jm = jbuild(dataclasses.replace(jcfg, attention_impl="chunked",
                                    attn_chunk=8))
    pm = build_model(dataclasses.replace(pcfg, attention_impl="chunked",
                                         attn_chunk=8), device="cpu")
    toks, patches = _inputs(pcfg, 2, 12, seed=4)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "patches": jnp.asarray(patches)}
    jloss, jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(jp)
    params = L.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    loss, _ = pm.loss(params, {k: torch.from_numpy(np.array(v))
                               for k, v in jb.items()})
    flat = _flat(params)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    assert abs(loss.item() - float(jloss)) <= TOL * max(1.0, abs(float(jloss)))
    want = _flat(jgrad)
    assert sorted(grads) == sorted(want) and "/patch_proj/kernel" in want
    assert float(np.abs(want["/patch_proj/kernel"]).max()) > 0
    for key, w in want.items():
        assert _rel(grads[key], w) <= TOL, key


def test_prefill_and_decode_steps(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    b, s, max_seq = 3, 10, 32
    toks, patches = _inputs(pcfg, b, s, seed=1)
    jc = jm.init_cache(b, max_seq)
    pc = pm.init_cache(b, max_seq)
    want, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                  "patches": jnp.asarray(patches)}, jc)
    got, pc, _ = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                                 "patches": torch.from_numpy(patches)}, pc)
    assert _rel(got, want) <= TOL
    assert set(pc) == set(jc)
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
        for key in jc:
            assert _rel(pc[key], jc[key]) <= TOL, (step, key)


def test_engine_matches_the_jax_engine(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    kw = dict(batch=3, max_seq=48, prefill_len=10, instrument=False)
    jeng = JEngine(jcfg, **kw)
    peng = ServeEngine(pcfg, device="cpu", **kw)
    assert tuple(peng.stub_inputs["patches"].shape) == (1, pcfg.n_patches,
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
                                            ("decode", 32, 3)])
def test_block_table_matches_the_reference(kind, seq, batch):
    """The dense family's blocks and program, as the reference's VLM."""
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models.model_zoo import build_model as jbuild
    jtab = JB.build_block_table(jbuild(jreduced(jget(ARCH))),
                                JShape("x", kind, seq, batch), unit="flops")
    ptab = PB.build_block_table(
        build_model(reduced(get_config(ARCH)), device="cpu"),
        ShapeConfig("x", kind, seq, batch), unit="flops")
    assert ptab.names == jtab.names == ["embed", "attn", "mlp", "head"]
    assert [(s.pattern, s.repeat) for s in ptab.program] == \
        [(s.pattern, s.repeat) for s in jtab.program]


def test_trainer_feeds_patches():
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              attention_impl="chunked", ssm_impl="chunked")
    tr = Trainer(cfg, seq_len=16, batch=2, device="cpu", instrument=False)
    assert tr.data.batch_at(0)["patches"].shape == (2, cfg.n_patches,
                                                    cfg.d_model)
    tr.run(2)
    assert all(np.isfinite(r["loss"]) for r in tr.metrics_history)
