"""The arithmetic of K3's bf16 kernel (csrc/ssd_tc.cu), emulated in plain
torch on the CPU, against the plain version `ssd_intra_plain`, within the
limit `chip_smoke.py` holds the kernel to (SSD_REL_TOL of each output's
largest magnitude).

The kernel multiplies on the tensor cores, whose operands are bf16: x, B and
C are bf16 already, but the weights of the y product, P = (C Bᵀ) ∘ L ∘ dt,
and the scaled x of the s_chunk product, x ∘ dt·exp(cum_last − cum), are
f32.
It splits each into hi = bf16(v) and lo = bf16(v − hi) and does two products
with the exact bf16 other operand, f32 sums throughout; C Bᵀ has exact bf16
operands and is one product.  The emulation does the same (the order of the
f32 sums aside, which moves an output by a few f32 ulp, far below the limit).
Its controls round the f32 operand once, to bf16: they must miss the limit,
or the test could not tell the split from no split."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import chunking, pad_steps, ssd_intra_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_limits",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SSD_REL_TOL = _smoke().SSD_REL_TOL


def _inputs(b, s, nh, hp, n, rates, seed=0):
    """bf16 x, B and C; f32 dt and A, at the model's own fast decay rates or
    at slow ones where every (t, s) pair shows (as chip_smoke._ssd_inputs)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, nh, hp),
                                             dtype=np.float32))
    Bp = torch.from_numpy(rng.standard_normal((b, s, n), dtype=np.float32))
    Cp = torch.from_numpy(rng.standard_normal((b, s, n), dtype=np.float32))
    if rates == "fast":
        dt = np.log1p(np.exp(rng.standard_normal((b, s, nh))))
        A = -(1.0 + 15.0 * rng.random(nh))
    else:
        dt = np.exp(np.log(1e-3) + np.log(100.0) * rng.random((b, s, nh)))
        A = -(0.05 + 0.45 * rng.random(nh))
    return (x.bfloat16(), torch.from_numpy(dt.astype(np.float32)),
            torch.from_numpy(A.astype(np.float32)), Bp.bfloat16(),
            Cp.bfloat16())


def _bf16(v):
    return v.bfloat16().float()


def _times(v, other, split):
    """v @ other with v rounded to bf16 as the kernel feeds the tensor cores:
    hi + lo (split) or once."""
    hi = _bf16(v)
    if not split:
        return torch.matmul(hi, other)
    return torch.matmul(hi, other) + torch.matmul(_bf16(v - hi), other)


def emulate(xh, dt, A, Bp, Cp, chunk, split_y=True, split_s=True):
    """(y_intra, s_chunk) as the bf16 kernel computes them."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nc, pad = chunking(s, chunk)
    xf = pad_steps(xh.float(), pad).reshape(b, nc, q, nh, hp)
    dtc = pad_steps(dt, pad).reshape(b, nc, q, nh)
    Bc = pad_steps(Bp.float(), pad).reshape(b, nc, q, n)
    Cc = pad_steps(Cp.float(), pad).reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * A, dim=2)                       # [b,c,q,nh]
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))              # exact operands
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [b,c,t,s,nh]
    tri = torch.ones((q, q), dtype=torch.bool).tril()[:, :, None]
    p = torch.where(tri, cb[..., None] * torch.exp(torch.where(tri, rel, 0.0))
                    * dtc[:, :, None, :, :], 0.0)            # [b,c,t,s,nh]
    y = _times(p.permute(0, 1, 4, 2, 3), xf.permute(0, 1, 3, 2, 4), split_y)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * q, nh, hp)[:, :s]
    w = dtc * torch.exp(cum[:, :, -1:, :] - cum)             # [b,c,q,nh]
    xw = (xf * w[..., None]).permute(0, 1, 3, 4, 2)          # [b,c,nh,hp,q]
    s_chunk = _times(xw, Bc[:, :, None], split_s)            # [b,c,nh,hp,N]
    return y, s_chunk


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# (B, S, nh, hp, N, chunk): the serving paths' head widths and states
# (mamba2-780m, zamba2-1.2b) at two heads, two chunks, and a ragged one
SHAPES = [(1, 512, 2, 64, 128, 256), (1, 512, 2, 64, 64, 256),
          (2, 300, 2, 32, 16, 256)]


@pytest.mark.parametrize("rates", ["fast", "slow"])
@pytest.mark.parametrize("b,s,nh,hp,n,chunk", SHAPES)
def test_split_products_meet_the_kernel_limit(b, s, nh, hp, n, chunk, rates):
    args = _inputs(b, s, nh, hp, n, rates)
    want_y, want_s = ssd_intra_plain(*args, chunk)[:2]
    y, s_chunk = emulate(*args, chunk)
    assert y.shape == want_y.shape and s_chunk.shape == want_s.shape
    assert _rel_err(y, want_y) <= SSD_REL_TOL
    assert _rel_err(s_chunk, want_s) <= SSD_REL_TOL


@pytest.mark.parametrize("rates", ["fast", "slow"])
@pytest.mark.parametrize("b,s,nh,hp,n,chunk", SHAPES)
def test_rounding_once_misses_the_kernel_limit(b, s, nh, hp, n, chunk, rates):
    """The controls: P rounded to bf16 once before the y product, and
    x ∘ dt·w rounded once before the s_chunk product (about 2e-3 of each
    output's scale here, ten times the limit)."""
    args = _inputs(b, s, nh, hp, n, rates)
    want_y, want_s = ssd_intra_plain(*args, chunk)[:2]
    y, s_chunk = emulate(*args, chunk, split_y=False, split_s=False)
    assert _rel_err(y, want_y) > SSD_REL_TOL
    assert _rel_err(s_chunk, want_s) > SSD_REL_TOL
