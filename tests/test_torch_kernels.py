"""Plain PyTorch versions of the port's kernels against the Pallas kernels (in
interpret mode) and the pure-jnp oracles, over the sweeps of test_kernels.py.
The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against these plain versions there).

Tolerances are the reference's own: 2e-5 for f32, 2e-2 for bf16 inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_jax, to_np, to_torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import ops as pops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode_plain, split_plan


def _tol(bf16):
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)


def _qkv(B, S, H, KV, hd, scale=1.0, sq=None, seed=7):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, sq or S, H, hd)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _check_attention(q, k, v, bf16, *, group, causal, window=None, cap=0.0,
                     bq=32, bk=32):
    got = flash_attention_plain(to_torch(q, bf16), to_torch(k, bf16),
                                to_torch(v, bf16), group=group, causal=causal,
                                window=window, cap=cap)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    jq, jk, jv = to_jax(q, bf16), to_jax(k, bf16), to_jax(v, bf16)
    jwin = None if window is None else jnp.int32(window)
    pallas = jops.flash_attention(jq, jk, jv, group=group, causal=causal,
                                  window=jwin, cap=cap, bq=bq, bk=bk)
    oracle = jref.flash_attention_ref(jq, jk, jv, group=group, causal=causal,
                                      window=window, cap=cap)
    np.testing.assert_allclose(to_np(got), to_np(pallas), **_tol(bf16))
    np.testing.assert_allclose(to_np(got), to_np(oracle), **_tol(bf16))


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 2, 1, 16),
    (2, 96, 4, 2, 32),
    (1, 128, 8, 8, 64),
    (2, 40, 6, 2, 16),          # non-multiple-of-block seq
])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_sweep(B, S, H, KV, hd, bf16, causal):
    q, k, v = _qkv(B, S, H, KV, hd)
    _check_attention(q, k, v, bf16, group=H // KV, causal=causal)


@pytest.mark.parametrize("window", [8, 24])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_window(window, causal):
    # causal=False with a window admits all future keys: the odd case is kept
    q, k, v = _qkv(2, 64, 4, 2, 16)
    _check_attention(q, k, v, False, group=2, causal=causal, window=window,
                     bq=16, bk=16)


def test_flash_attention_plain_window_tensor():
    q, k, v = _qkv(2, 64, 4, 2, 16)
    args = [to_torch(a) for a in (q, k, v)]
    a = flash_attention_plain(*args, group=2, window=torch.tensor(8))
    b = flash_attention_plain(*args, group=2, window=8)
    c = flash_attention_plain(*args, group=2, window=torch.tensor(-1))
    d = flash_attention_plain(*args, group=2, window=None)
    assert torch.equal(a, b) and torch.equal(c, d)


def test_flash_attention_plain_softcap():
    q, k, v = _qkv(1, 32, 2, 2, 16, scale=4.0)
    _check_attention(q, k, v, False, group=1, causal=True, cap=20.0,
                     bq=16, bk=16)


def _check_decode(B, S, H, KV, hd, bf16, lens, *, window=None, cap=0.0,
                  pallas=True):
    """``pallas=False`` holds the plain version against the oracle alone."""
    q, k, v = _qkv(B, S, H, KV, hd, sq=1)
    lens = np.asarray(lens, np.int32)
    got = flash_decode_plain(to_torch(q, bf16), to_torch(k, bf16),
                             to_torch(v, bf16), torch.from_numpy(lens),
                             group=H // KV, window=window, cap=cap)
    jq, jk, jv = to_jax(q, bf16), to_jax(k, bf16), to_jax(v, bf16)
    oracle = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(lens),
                                   group=H // KV, window=window, cap=cap)
    np.testing.assert_allclose(to_np(got), to_np(oracle), **_tol(bf16))
    if pallas:
        jwin = None if window is None else jnp.int32(window)
        out = jops.flash_decode(jq, jk, jv, jnp.asarray(lens), group=H // KV,
                                window=jwin, cap=cap, bk=32)
        np.testing.assert_allclose(to_np(got), to_np(out), **_tol(bf16))


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 96, 4, 2, 32),
    (3, 50, 8, 4, 16),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_decode_plain_sweep(B, S, H, KV, hd, bf16):
    lens = np.random.default_rng(3).integers(1, S + 1, size=B)
    _check_decode(B, S, H, KV, hd, bf16, lens)


@pytest.mark.parametrize("window,cap", [(8, 0.0), (-1, 20.0), (24, 20.0)])
def test_flash_decode_plain_window_cap(window, cap):
    _check_decode(3, 50, 8, 4, 16, False, [50, 7, 30], window=window, cap=cap)


@pytest.mark.parametrize("S,pallas", [(64, True), (50, False)])
def test_flash_decode_plain_length_beyond_cache(S, pallas):
    # an idle slot's length keeps growing past the cache: the row then sees
    # the whole cache, as in the oracle.  The Pallas kernel pads a ragged
    # cache with zero keys and lets such a row see them, so it is compared
    # only where S is a multiple of its block.
    _check_decode(3, S, 8, 4, 16, False, [S + 3, S, 1], pallas=pallas)


def test_wrappers_take_plain_version_on_cpu():
    q, k, v = (to_torch(a) for a in _qkv(2, 40, 6, 2, 16))
    before = build.launches()
    out = pops.flash_attention(q, k, v, group=3, causal=True, window=8)
    want = flash_attention_plain(q, k, v, group=3, causal=True, window=8)
    assert torch.equal(out, want)
    lens = torch.tensor([40, 3], dtype=torch.int32)
    out = pops.flash_decode(q[:, :1], k, v, lens, group=3)
    want = flash_decode_plain(q[:, :1], k, v, lens, group=3)
    assert torch.equal(out, want)
    # no kernel was launched: the counters only move on the card
    assert build.launches() == before


@pytest.mark.parametrize("b,kv,s,tile", [(8, 8, 1024, 32), (1, 1, 50, 32),
                                         (2, 4, 4096, 32), (64, 8, 100, 32)])
def test_split_plan_covers_cache(b, kv, s, tile):
    n_splits, chunk = split_plan(b, kv, s, tile)
    assert chunk % tile == 0 and n_splits >= 1
    assert (n_splits - 1) * chunk < s <= n_splits * chunk
