"""The port's Mamba2 / SSD against the JAX package's on the same numpy inputs
(f32, CPU): K3's plain version against the Pallas kernel in interpret mode,
`ops.ssd` against the reference's `ops.ssd` and the `ssd_ref` oracle,
`ssd_chunked` / `ssd_reference`, the causal conv, and the block-level
`mamba2_block` (each impl) and `mamba2_decode`.

Tolerances are the reference's own: 2e-4 for the SSD against its oracle
(tests/test_kernels.py) and 1e-4 between two chunked implementations of the
same sums (tests/test_kernels.py:103).  A whole block is held to 2e-4 of its
output's largest magnitude: the gated RMSNorm at its end scales f32 rounding
with the output, whose entries reach 30 here, and the reference's own
chunked and step-by-step SSDs already differ by 1e-5 of that scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_scale, model_pair, to_np
from repro.configs import get_config as jget, reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_intra as j_ssd_intra
from repro.models import ssm as JS
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import ops as pops
from repro_torch.kernels.ssd import chunking, ssd_intra, ssd_intra_plain
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
CHUNKED_TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_kernels.py:83-87, plus S shorter than the chunk
SWEEP = [(1, 64, 2, 16, 8, 16), (2, 96, 3, 16, 8, 32), (1, 80, 4, 32, 16, 32),
         (2, 40, 2, 16, 8, 64)]


def _ssd_inputs(B, S, nh, hp, N, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh))).astype(np.float32)
    Bp = rng.standard_normal((B, S, N)).astype(np.float32)
    Cp = rng.standard_normal((B, S, N)).astype(np.float32)
    return xh, dt, A, Bp, Cp


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("B,S,nh,hp,N,chunk", SWEEP)
def test_ssd_intra_plain_matches_the_pallas_kernel(B, S, nh, hp, N, chunk):
    jx, px = _both(_ssd_inputs(B, S, nh, hp, N))
    jy, js, jd, jc = j_ssd_intra(*jx, chunk, interpret=True)
    y, s_chunk, decay, cum = ssd_intra_plain(*px, chunk)
    q, nc, _ = chunking(S, chunk)
    assert y.shape == (B, S, nh, hp) and s_chunk.shape == (B, nc, nh, hp, N)
    assert decay.shape == (B, nc, nh) and y.dtype == torch.float32
    assert cum.shape == (B, nc, q, nh) and cum.dtype == torch.float32
    np.testing.assert_allclose(to_np(y), to_np(jy)[:, :S], **SSD_TOL)
    np.testing.assert_allclose(to_np(s_chunk), to_np(js), **SSD_TOL)
    np.testing.assert_allclose(to_np(decay), to_np(jd), **SSD_TOL)
    np.testing.assert_allclose(to_np(cum), to_np(jc), **SSD_TOL)


@pytest.mark.parametrize("B,S,nh,hp,N,chunk", SWEEP)
def test_ops_ssd_matches_the_reference_and_the_oracle(B, S, nh, hp, N, chunk):
    jx, px = _both(_ssd_inputs(B, S, nh, hp, N, seed=1))
    y, h = pops.ssd(*px, chunk=chunk)
    jy, jh = jops.ssd(*jx, chunk=chunk)
    oy, oh = jref.ssd_ref(*jx)
    for want_y, want_h in ((jy, jh), (oy, oh)):
        np.testing.assert_allclose(to_np(y), to_np(want_y), **SSD_TOL)
        np.testing.assert_allclose(to_np(h), to_np(want_h), **SSD_TOL)


@pytest.mark.parametrize("B,S,nh,hp,N,chunk", SWEEP[:3])
def test_ssd_chunked_and_reference_match_the_jax_package(B, S, nh, hp, N,
                                                         chunk):
    jx, px = _both(_ssd_inputs(B, S, nh, hp, N, seed=2))
    y, h = PS.ssd_chunked(*px, chunk)
    jy, jh = JS.ssd_chunked(*jx, chunk)
    np.testing.assert_allclose(to_np(y), to_np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(to_np(h), to_np(jh), **CHUNKED_TOL)
    y, h = PS.ssd_reference(*px)
    jy, jh = JS.ssd_reference(*jx)
    np.testing.assert_allclose(to_np(y), to_np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(to_np(h), to_np(jh), **CHUNKED_TOL)


def test_ssd_chunked_carries_an_initial_state():
    jx, px = _both(_ssd_inputs(2, 40, 2, 16, 8, seed=3))
    h0 = np.random.default_rng(4).standard_normal((2, 2, 16, 8)).astype(
        np.float32)
    y, h = PS.ssd_chunked(*px, 16, h0=torch.from_numpy(h0))
    jy, jh = JS.ssd_chunked(*jx, 16, h0=jnp.asarray(h0))
    np.testing.assert_allclose(to_np(y), to_np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(to_np(h), to_np(jh), **CHUNKED_TOL)


def test_ssd_intra_wrapper_takes_the_plain_version_on_cpu():
    _, px = _both(_ssd_inputs(1, 40, 2, 16, 8))
    before = build.launches()
    got = ssd_intra(*px, 16)
    want = ssd_intra_plain(*px, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.launches() == before     # counts launches on the card only


@pytest.mark.parametrize("s,chunk,want", [(64, 16, (16, 4, 0)),
                                          (80, 32, (32, 3, 16)),
                                          (40, 64, (40, 1, 0)),
                                          (512, 256, (256, 2, 0))])
def test_chunking(s, chunk, want):
    assert chunking(s, chunk) == want


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jst = jnp.asarray(st) if with_state else None
    pst = torch.from_numpy(st) if with_state else None
    jy, jnew = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jst)
    py, pnew = PS._causal_conv(torch.from_numpy(x), torch.from_numpy(w), pst)
    np.testing.assert_allclose(to_np(py), to_np(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(to_np(pnew), to_np(jnew))


# ---------------------------------------------------------------------------
# Block level, on converted parameters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """(jax cfg, jax params, port cfg, port params) of layer 0 of reduced
    mamba2, the port's converted from the JAX ones."""
    jcfg, _, jparams, pcfg, _, _ = model_pair("mamba2-780m")
    tree = jax.tree.map(np.asarray, jparams)
    # dt_bias away from its initial 0, so that it matters
    bias = tree["layers"]["ssm"]["dt_bias"]
    tree["layers"]["ssm"]["dt_bias"] = 0.5 * np.random.default_rng(6) \
        .standard_normal(bias.shape).astype(np.float32)
    pparams = params_from_numpy(tree, pcfg, device="cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])
    return jcfg, jp, pcfg, PT.layer_params(pparams, pcfg, 0)["ssm"]


def _x(cfg, b, s, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["cuda", "chunked", "reference"])
def test_mamba2_block_matches_for_each_impl(block, impl):
    jcfg, jp, pcfg, pp = block
    x = _x(pcfg, 2, 40)                     # three chunks of 16, the last ragged
    want = JS.mamba2_block(jp, jcfg, jnp.asarray(x))
    got = PS.mamba2_block(pp, dataclasses.replace(pcfg, ssm_impl=impl),
                          torch.from_numpy(x))
    assert_close_to_scale(got, want)


def test_mamba2_block_pallas_impl_is_the_jax_packages(block):
    jcfg, jp, pcfg, pp = block
    with pytest.raises(NotImplementedError, match="JAX package"):
        PS.mamba2_block(pp, pcfg, torch.zeros((1, 4, pcfg.d_model)),
                        impl="pallas")


def test_mamba2_decode_matches_and_updates_the_state_in_place(block):
    jcfg, jp, pcfg, pp = block
    d_inner, nh = PS.ssm_dims(pcfg)
    rng = np.random.default_rng(8)
    x = _x(pcfg, 3, 1, seed=9)
    h0 = rng.standard_normal((3, nh, pcfg.ssm.head_dim,
                              pcfg.ssm.d_state)).astype(np.float32)
    conv = [rng.standard_normal((3, pcfg.ssm.d_conv - 1, c)).astype(np.float32)
            for c in (d_inner, pcfg.ssm.d_state, pcfg.ssm.d_state)]
    jout, jh, jconv = JS.mamba2_decode(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(h0),
                                       tuple(jnp.asarray(c) for c in conv))
    state = torch.from_numpy(h0.copy())
    out, h, pconv = PS.mamba2_decode(pp, pcfg, torch.from_numpy(x), state,
                                     tuple(torch.from_numpy(c) for c in conv))
    assert h is state                         # the cache layer, in place
    assert_close_to_scale(out, jout)
    np.testing.assert_allclose(to_np(h), to_np(jh), **SSD_TOL)
    for a, b in zip(pconv, jconv):          # projections: matmul rounding
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-5)


def test_specs_match_the_reference(block):
    jcfg, jp, pcfg, pp = block
    want = jax.tree.map(lambda s: tuple(s.shape), JS.mamba2_specs(jcfg),
                        is_leaf=lambda s: hasattr(s, "axes"))
    got = jax.tree.map(lambda s: tuple(s.shape), PS.mamba2_specs(pcfg),
                       is_leaf=lambda s: hasattr(s, "axes"))
    assert got == want
    assert PS.conv_dim(pcfg) == JS.conv_dim(jcfg)
    assert PS.ssm_dims(pcfg) == JS.ssm_dims(jcfg)
    # A = -exp(A_log) with A_log = log U(1, 16): -16 <= A <= -1
    fresh = PT.layer_specs(pcfg, PT.ModelDims.make(pcfg, 1))
    a_log = fresh["ssm"]["A_log"].instantiate(torch.Generator().manual_seed(0),
                                              torch.float32, "cpu")
    assert a_log.shape == (PS.ssm_dims(pcfg)[1],)
    assert bool(((a_log >= 0) & (a_log <= np.log(16.0))).all())
