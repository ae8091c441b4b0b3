"""The port's attention module against the JAX package's on the same numpy
inputs (f32, CPU): projections with qk-norm and bias, the output projection
with the pad-head mask, the implementation switch, decode.  Tolerance 2e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_np
from repro.configs.base import AttnConfig as JAttn
from repro.models import attention as JA
from repro_torch.configs.base import AttnConfig as PAttn
from repro_torch.models import attention as PA

TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(5)
D = 32


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _params(h, kv, hd, *, qk_norm, bias):
    r = lambda *s: (RNG.standard_normal(s) / 4).astype(np.float32)   # noqa: E731
    p = {"wq": {"kernel": r(D, h, hd)}, "wk": {"kernel": r(D, kv, hd)},
         "wv": {"kernel": r(D, kv, hd)}, "wo": {"kernel": r(h, hd, D)}}
    if bias:
        p["wq"]["bias"], p["wk"]["bias"], p["wv"]["bias"] = \
            r(h, hd), r(kv, hd), r(kv, hd)
    if qk_norm:
        p["q_norm"] = {"scale": 1 + r(hd)}
        p["k_norm"] = {"scale": 1 + r(hd)}
    return p


def _layouts(h, kv, hd, tp=1, **kw):
    ja, pa = JAttn(h, kv, hd, **kw), PAttn(h, kv, hd, **kw)
    return ja, pa, JA.HeadLayout.make(ja, tp), PA.HeadLayout.make(pa, tp)


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
@pytest.mark.parametrize("h,kv", [(16, 8), (40, 8), (4, 1), (6, 2)])
def test_head_layout_matches(tp, h, kv):
    ja, pa, jl, pl = _layouts(h, kv, 16, tp)
    assert dataclasses.asdict(jl) == dataclasses.asdict(pl)
    assert (jl.group, jl.g_real, jl.n_pad) == (pl.group, pl.g_real, pl.n_pad)
    np.testing.assert_array_equal(jl.head_mask(), pl.head_mask())


@pytest.mark.parametrize("qk_norm,bias", [(True, False), (False, True)])
def test_qkv(qk_norm, bias):
    h, kv, hd = 4, 2, 16
    ja, pa, jl, pl = _layouts(h, kv, hd, qk_norm=qk_norm, qkv_bias=bias,
                              rope_theta=1e6)
    p = _params(h, kv, hd, qk_norm=qk_norm, bias=bias)
    x = RNG.standard_normal((2, 9, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    want = JA.qkv(_tree(jnp.asarray, p), ja, jl, jnp.asarray(x),
                  jnp.asarray(pos), jnp.float32)
    got = PA.qkv(_tree(torch.from_numpy, p), pa, pl, torch.from_numpy(x),
                 torch.from_numpy(pos), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **TOL)


def test_out_proj_masks_pad_heads():
    # tp=4 with 6 q heads / 2 kv heads pads the q slots: pad heads carry
    # garbage in ctx and must not reach the output
    ja, pa, jl, pl = _layouts(6, 2, 16, tp=4)
    assert pl.n_pad > 0
    wo = (RNG.standard_normal((pl.h_pad, 16, D)) / 4).astype(np.float32)
    ctx = RNG.standard_normal((2, 5, pl.h_pad, 16)).astype(np.float32)
    want = JA.out_proj({"wo": {"kernel": jnp.asarray(wo)}}, jl,
                       jnp.asarray(ctx), jnp.float32)
    got = PA.out_proj({"wo": {"kernel": torch.from_numpy(wo)}}, pl,
                      torch.from_numpy(ctx), torch.float32)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def _qkv_arrays(b, s, h, kv, hd, sq=None):
    q = RNG.standard_normal((b, sq or s, h, hd)).astype(np.float32)
    k = RNG.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = RNG.standard_normal((b, s, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("window,cap", [(-1, 0.0), (8, 0.0), (-1, 20.0)])
def test_attend_impls(impl, window, cap):
    """`cuda` on a CPU tensor is the flash-attention kernel's plain version;
    both of the port's impls against the JAX `reference` and `pallas`."""
    b, s, h, kv, hd = 2, 40, 4, 2, 16
    ja, pa, jl, pl = _layouts(h, kv, hd)
    q, k, v = _qkv_arrays(b, s, h, kv, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    got = PA.attend(impl, *(torch.from_numpy(a) for a in (q, k, v)),
                    torch.from_numpy(pos), torch.from_numpy(pos), pl,
                    causal=True, window=window, cap=cap)
    for jimpl in ("reference", "pallas"):
        want = JA.attend(jimpl, *(jnp.asarray(a) for a in (q, k, v)),
                         jnp.asarray(pos), jnp.asarray(pos), jl, causal=True,
                         window=jnp.int32(window), cap=cap)
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_attend_rejects_impls_of_the_jax_package():
    _, _, _, pl = _layouts(4, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in _qkv_arrays(1, 8, 4, 2, 16))
    pos = torch.arange(8)[None]
    with pytest.raises(NotImplementedError):
        PA.attend("pallas", q, k, v, pos, pos, pl, causal=True, window=-1)
    with pytest.raises(ValueError):
        PA.attend("nope", q, k, v, pos, pos, pl, causal=True, window=-1)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("window,cap", [(-1, 0.0), (8, 20.0)])
def test_attend_decode(impl, window, cap):
    """`cuda` on a CPU tensor is the flash-decode kernel's plain version."""
    b, s, h, kv, hd = 3, 50, 8, 4, 16
    ja, pa, jl, pl = _layouts(h, kv, hd)
    q, k, v = _qkv_arrays(b, s, h, kv, hd, sq=1)
    lens = np.asarray([50, 1, 23], np.int32)
    want = JA.attend_decode(*(jnp.asarray(a) for a in (q, k, v)),
                            jnp.asarray(lens), jl, window=jnp.int32(window),
                            cap=cap)
    got = PA.attend_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(lens), pl, window=window, cap=cap,
                           impl=impl)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_mask_bias():
    qp = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    for causal in (True, False):
        for window in (-1, 0, 3):
            want = JA._mask_bias(jnp.asarray(qp), jnp.asarray(qp),
                                 jnp.int32(window), causal)
            got = PA._mask_bias(torch.from_numpy(qp), torch.from_numpy(qp),
                                window, causal)
            got_t = PA._mask_bias(torch.from_numpy(qp), torch.from_numpy(qp),
                                  torch.tensor(window), causal)
            np.testing.assert_array_equal(to_np(got), to_np(want))
            np.testing.assert_array_equal(to_np(got_t), to_np(want))
