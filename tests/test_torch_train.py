"""The training path of the port against the JAX package's, on the CPU at the
reduced size (f32): attention, loss, the kernels' refusal of autograd, the
SSD's gradient, the train table, `Trainer` and the launcher.  The train step
itself, from converted parameters, is `tests/test_torch_train_step.py`.

f32 model math is held to 2e-4 (`tests/test_models.py`'s cross-implementation
tolerance) relative to max(1, the largest magnitude of the JAX value); the
streaming attention alone to 2e-5 (`tests/test_kernels.py`'s f32 tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_np
from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models import ssm as JS
from repro.models.attention import HeadLayout as JLayout
from repro.models.model_zoo import cross_entropy as j_cross_entropy
from repro_torch.configs import AttnConfig, get_config, reduced
from repro_torch.data import SyntheticCorpus
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 refuse_grad)
from repro_torch.models import attention as PA
from repro_torch.models import ssm as PS
from repro_torch.models.model_zoo import cross_entropy
from repro_torch.train import Trainer

TOL = 2e-4
ATTN_TOL = 2e-5
SEQ, BATCH = 32, 2            # two reduced SSD chunks of 16


def _rel(got, want) -> float:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _batch(cfg, step=0, seq=SEQ, batch=BATCH):
    b = SyntheticCorpus(cfg.vocab_size, seq, batch, seed=0).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items() if k != "domains"},
            {k: torch.from_numpy(v) for k, v in b.items() if k != "domains"})


def _train_cfg(cfg):
    return dataclasses.replace(cfg, attention_impl="chunked",
                               ssm_impl="chunked")


# ---------------------------------------------------------------------------
# attend_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,window,cap,causal_skip", [
    (8, -1, 0.0, False), (8, 5, 5.0, True), (16, -1, 5.0, True),
    (16, 5, 0.0, False)])
def test_attend_chunked_matches_the_jax_package(chunk, window, cap,
                                                causal_skip):
    """Values and gradients (q, k, v) of a weighted sum of the output,
    against `jax.grad` of the JAX `attend_chunked` and against the port's
    quadratic `attend_reference`.  S = 37 is not a multiple of either chunk
    (padded q and k positions); GQA with 2 q heads a kv head."""
    b, s, h, kv, hd = 2, 37, 4, 2, 16
    rng = np.random.default_rng(chunk + 10 * (window + 1))
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    w = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jl = JLayout.make(jget("qwen3-1.7b").attn.__class__(h, kv, hd), 1)
    pl = PA.HeadLayout.make(AttnConfig(h, kv, hd), 1)
    kw = dict(causal=True, cap=cap, q_chunk=chunk, kv_chunk=chunk,
              causal_skip=causal_skip)

    def jf(q, k, v):
        out = JA.attend_chunked(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                jl, window=jnp.int32(window), **kw)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = PA.attend_chunked(tq, tk, tv, tpos, tpos, pl, window=window, **kw)
    pg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    ref = PA.attend_reference(tq, tk, tv, tpos, tpos, pl, causal=True,
                              window=window, cap=cap)
    assert _rel(out, jout) <= ATTN_TOL
    assert _rel(out, ref) <= ATTN_TOL
    for got, want in zip(pg, jg):
        assert _rel(got, want) <= ATTN_TOL


def test_attend_chunked_without_causal_mask_and_through_attend():
    """`attend("chunked")` without the causal mask: against the quadratic
    version where S is a multiple of the chunk; on a ragged S the zero keys
    of the padding are not masked (only the causal mask removes them), in
    the JAX package as here, so there it is held to the JAX package."""
    h, kv, hd = 2, 1, 16
    rng = np.random.default_rng(3)
    pl = PA.HeadLayout.make(AttnConfig(h, kv, hd), 1)
    jl = JLayout.make(jget("qwen3-1.7b").attn.__class__(h, kv, hd), 1)
    for s in (24, 20):
        q, k, v = (rng.standard_normal((1, s, n, hd)).astype(np.float32)
                   for n in (h, kv, kv))
        pos = np.arange(s, dtype=np.int32)[None]
        got = PA.attend("chunked", *map(torch.from_numpy, (q, k, v, pos, pos)),
                        pl, causal=False, window=-1, q_chunk=8, kv_chunk=8)
        want = JA.attend("chunked", *map(jnp.asarray, (q, k, v, pos, pos)),
                         jl, causal=False, window=jnp.int32(-1), q_chunk=8,
                         kv_chunk=8)
        assert _rel(got, want) <= ATTN_TOL
        if s % 8 == 0:
            ref = PA.attend("reference", *map(torch.from_numpy,
                                              (q, k, v, pos, pos)),
                            pl, causal=False, window=-1)
            assert _rel(got, ref) <= ATTN_TOL


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------


def test_cross_entropy_value_and_gradient_match_the_jax_package():
    """With a tie for the largest logit in one row: the reference's max is
    differentiated where it is added back, and both split its gradient
    evenly between tied entries."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    logits[0, 0, 3] = logits[0, 0, 7] = logits[0, 0].max() + 1.0
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)

    def jf(lg):
        loss, nll = j_cross_entropy(lg, jnp.asarray(labels), 11)
        return loss, nll

    (jl, jn), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    pl, pn = cross_entropy(t, torch.from_numpy(labels), 11)
    (pg,) = torch.autograd.grad(pl, t)
    assert abs(pl.item() - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(pn, jn) <= 1e-6
    assert _rel(pg, jg) <= 1e-6


# ---------------------------------------------------------------------------
# the kernels refuse to be differentiated through
# ---------------------------------------------------------------------------


def test_refuse_grad_raises_only_under_grad_on_tensors_that_require_it():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match='"chunked"'):
        refuse_grad("flash_attention", y, x)
    refuse_grad("flash_attention", y, y)
    with torch.no_grad():
        refuse_grad("flash_attention", x, y)


def test_plain_versions_stay_differentiable_on_the_cpu():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = flash_attention(q, q[:, :, :1].detach(), q[:, :, :1].detach(),
                          group=2)
    assert out.grad_fn is not None


def test_trainer_refuses_the_kernels():
    cfg = reduced(get_config("qwen3-1.7b"))
    for field in ("attention_impl", "ssm_impl"):
        bad = dataclasses.replace(_train_cfg(cfg), **{field: "cuda"})
        with pytest.raises(ValueError, match=f"{field}='chunked'"):
            Trainer(bad, device="cpu", instrument=False)


# ---------------------------------------------------------------------------
# the SSD's gradient against a float64 oracle
# ---------------------------------------------------------------------------


def _ssd_oracle_f64(xh, dt, A, Bp, Cp):
    b, s, nh, hp = xh.shape
    h = torch.zeros((b, nh, hp, Bp.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t] * A[None])
        h = a[..., None, None] * h + (xh[:, t] * dt[:, t][..., None]
                                      )[..., None] * Bp[:, t, None, None, :]
        ys.append(torch.matmul(h, Cp[:, t, None, :, None])[..., 0])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("dt_scale", [1.0, 4.0])
def test_ssd_chunked_gradients_are_as_accurate_as_the_jax_package(dt_scale):
    """Gradients of (y, h_final) through the port's `ssd_chunked` (f32), the
    JAX package's (f32) and a float64 step-by-step oracle: the port's error
    against the oracle is at most twice the JAX package's plus 1e-6 of
    scale, on two chunks of 16 with the model's fast decay rates."""
    b, s, nh, hp, n = 2, 32, 8, 16, 16
    rng = np.random.default_rng(int(dt_scale))
    args = [rng.standard_normal((b, s, nh, hp)),
            np.log1p(np.exp(rng.standard_normal((b, s, nh)))) * dt_scale,
            -rng.uniform(1, 16, nh), rng.standard_normal((b, s, n)),
            rng.standard_normal((b, s, n))]
    args = [a.astype(np.float32) for a in args]
    wy = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    wh = rng.standard_normal((b, nh, hp, n)).astype(np.float32)

    def torch_grads(fn, dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
        y, h = fn(*ts)
        obj = (y * torch.tensor(wy, dtype=dtype)).sum() + \
            (h * torch.tensor(wh, dtype=dtype)).sum()
        return [g.double().numpy() for g in torch.autograd.grad(obj, ts)]

    def jax_obj(*a):
        y, h = JS.ssd_chunked(*a, 16)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    truth = torch_grads(_ssd_oracle_f64, torch.float64)
    port = torch_grads(lambda *a: PS.ssd_chunked(*a, 16), torch.float32)
    ref = jax.grad(jax_obj, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    for name, p, j, t in zip(("x", "dt", "A", "B", "C"), port, ref, truth):
        scale = np.abs(t).max()
        err_p = np.abs(p - t).max() / scale
        err_j = np.abs(np.asarray(j, np.float64) - t).max() / scale
        assert err_p <= 2 * err_j + 1e-6, (name, err_p, err_j)
