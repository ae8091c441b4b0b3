"""The port's AdamW and LR schedules against the JAX package's
(`src/repro/optim/`), on the same numpy inputs.

Both sides compute in f32 in the same order, so the tolerance is 1e-6
relative to each leaf's scale (f32 rounding of a few ops), well inside the
reference's own cross-implementation tolerance of 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro.optim import schedule as JS
from repro_torch.optim import adamw as PO
from repro_torch.optim import schedule as PS

TOL = 1e-6


def _tree(rng, scale):
    def leaf(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"a": leaf(5, 7), "b": {"c": leaf(3), "d": leaf(2, 4, 3)}}


def _map(fn, t):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


def _leaves(t):
    return [x for v in t.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _close(jtree, ptree):
    for a, b in zip(_leaves(jtree), _leaves(ptree)):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("clip", [1.0, 100.0, 0.0],
                         ids=["clip-active", "clip-inactive", "no-clip"])
@pytest.mark.parametrize("master,bf16", [(True, False), (False, False),
                                         (True, True)],
                         ids=["master", "no-master", "bf16-with-master"])
def test_adamw_update_matches_the_jax_package(clip, master, bf16):
    """1 and 3 updates (a schedule in warmup, then cosine); the gradients
    of the second update are large, so a clip of 1 is active there."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 1.0)
    grads = [_tree(rng, s) for s in (0.01, 3.0, 0.02)]
    jcfg = JO.AdamWConfig(lr=1e-2, grad_clip=clip, use_master=master)
    pcfg = PO.AdamWConfig(lr=1e-2, grad_clip=clip, use_master=master)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    pdt = torch.bfloat16 if bf16 else torch.float32
    jp = _map(lambda a: jnp.asarray(a).astype(jdt), p0)
    pp = _map(lambda a: torch.tensor(a).to(pdt), p0)
    js, ps = JO.init_opt_state(jp, jcfg), PO.init_opt_state(pp, pcfg)
    jlr, plr = (JS.linear_warmup_cosine(1e-2, 2, 10),
                PS.linear_warmup_cosine(1e-2, 2, 10))
    for n, g in enumerate(grads, start=1):
        jp, js, jm = JO.adamw_update(jp, _map(jnp.asarray, g), js, jcfg,
                                     jlr(js.step))
        pp, ps, pm = PO.adamw_update(pp, _map(torch.tensor, g), ps, pcfg,
                                     plr(ps.step))
        if n in (1, 3):
            _close(jp, pp)
            _close(js.mu, ps.mu)
            _close(js.nu, ps.nu)
            if master:
                _close(js.master, ps.master)
            assert int(js.step) == int(ps.step) == n
            assert abs(float(jm["grad_norm"]) - pm["grad_norm"].item()) <= \
                TOL * float(jm["grad_norm"])
            assert float(jm["lr"]) == pm["lr"].item()
        assert pp["a"].dtype == pdt


def test_master_weights_accumulate_below_bf16_resolution():
    cfg = PO.AdamWConfig(lr=1e-4, use_master=True, grad_clip=0,
                         weight_decay=0.0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = PO.init_opt_state(params, cfg)
    for _ in range(50):
        g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
        params, state, _ = PO.adamw_update(params, g, state, cfg,
                                           torch.tensor(1e-5))
    assert float(state.master["w"][0]) != 1.0


def test_clip_by_global_norm_matches_the_jax_package():
    rng = np.random.default_rng(1)
    for scale in (10.0, 1e-3):
        g = _tree(rng, scale)
        jc, jn = JO.clip_by_global_norm(_map(jnp.asarray, g), 1.0)
        pc, pn = PO.clip_by_global_norm(_map(torch.tensor, g), 1.0)
        _close(jc, pc)
        assert abs(float(jn) - pn.item()) <= TOL * float(jn)


@pytest.mark.parametrize("sched", ["warmup_cosine", "constant"])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_schedules_match_the_jax_package(sched, as_tensor):
    """Steps 0..N+2, given as an int32 scalar tensor and as an int: equal
    f32 values (both evaluate the same f32 expression)."""
    if sched == "constant":
        jf, pf = JS.constant(3e-4), PS.constant(3e-4)
    else:
        jf, pf = (JS.linear_warmup_cosine(3e-4, 3, 10),
                  PS.linear_warmup_cosine(3e-4, 3, 10))
    for step in range(13):
        want = np.float32(jf(jnp.int32(step) if as_tensor else step))
        got = pf(torch.tensor(step, dtype=torch.int32) if as_tensor else step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert np.float32(got.item()) == want, (step, got, want)
