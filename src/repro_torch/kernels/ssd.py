# Counterpart of src/repro/kernels/ssd.py (`ssd_intra`, body `_ssd_kernel`,
# `pallas_call` at :82).  Forward only, as there.  `ssd_intra` returns the
# reference's four outputs; its `cum` is written by the kernel itself (the
# reference recomputes it outside), and `y` is not padded to whole chunks.
"""SSD (Mamba2) intra-chunk tile: a CUDA kernel written by hand for Hopper,
its plain PyTorch version, and the wrapper that chooses between them by where
the tensor lies.

The kernel (``csrc/ssd.cu``) replaces the Pallas TPU kernel ``_ssd_kernel``
of ``src/repro/kernels/ssd.py:62``.  Per (batch, head, chunk of q steps):
``cum = cumsum(dt·A)``; ``y_intra = (L ∘ (C Bᵀ)) (x·dt)`` with
``L[t,s] = exp(cum_t − cum_s)`` for t ≥ s, else 0; ``s_chunk =
(x·dt·exp(cum_last − cum))ᵀ B``; ``decay = exp(cum_last)``; and ``cum``
itself, which the inter-chunk term of ``ops.ssd`` needs.

On this card the function is bound by bytes: it reads x, dt, B and C once
and writes y and s_chunk once (about 13 MB at mamba2-780m's prefill shape),
while its products are about 1.2 GFLOP when ``C Bᵀ``, which all heads share,
is counted once per (batch, chunk).  The first design keeps every
intermediate out of device memory (one block per (batch, head, chunk), the
chunk cut into tiles of 64 steps, the cumsum a block-wide prefix sum in
shared memory, the y rows in registers, s_chunk accumulated by the last t
tile), masks the ragged last chunk in the kernel instead of padding it in
device memory, and never exponentiates above the diagonal.  It recomputes
``C Bᵀ`` per head and runs on the CUDA cores in IEEE f32; sharing ``C Bᵀ``
across heads and the tensor cores are what is left between it and the bound.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES

HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128


def chunking(s: int, chunk: int) -> Tuple[int, int, int]:
    """(q, nc, pad): steps per chunk, chunks, zero steps after the last."""
    q = min(chunk, s)
    nc = -(-s // q)
    return q, nc, nc * q - s


def pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero steps after the last along axis 1 of [B,S,...]."""
    if not pad:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_intra_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bp: torch.Tensor, Cp: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version.  xh [B,S,nh,hp]; dt [B,S,nh] f32; A [nh] f32;
    Bp/Cp [B,S,N].  Returns (y_intra [B,S,nh,hp], s_chunk [B,nc,nh,hp,N],
    decay [B,nc,nh], cum [B,nc,q,nh]), all f32.  The ragged last chunk is
    zero-padded, as in the reference."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nc, pad = chunking(s, chunk)
    xf = pad_steps(xh.float(), pad).reshape(b, nc, q, nh, hp)
    dtc = pad_steps(dt.float(), pad).reshape(b, nc, q, nh)
    Bc = pad_steps(Bp.float(), pad).reshape(b, nc, q, n)
    Cc = pad_steps(Cp.float(), pad).reshape(b, nc, q, n)

    cum = torch.cumsum(dtc * A, dim=2)                     # [b,c,q,nh]
    xdt = xf * dtc[..., None]                              # [b,c,q,nh,hp]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [b,c,t,s,nh]
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    # mask before exp: the upper triangle is never exponentiated
    Lk = torch.exp(torch.where(tri[:, :, None], rel, -torch.inf))
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))            # [b,c,t,s]
    w = (Lk * cb[..., None]).permute(0, 1, 4, 2, 3)        # [b,c,nh,t,s]
    y = torch.matmul(w, xdt.permute(0, 1, 3, 2, 4))        # [b,c,nh,t,hp]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * q, nh, hp)[:, :s]

    decay_out = torch.exp(cum[:, :, -1:, :] - cum)         # [b,c,q,nh]
    xw = (xdt * decay_out[..., None]).permute(0, 1, 3, 4, 2)   # [b,c,nh,hp,q]
    s_chunk = torch.matmul(xw, Bc[:, :, None])             # [b,c,nh,hp,N]
    return y, s_chunk, torch.exp(cum[:, :, -1]), cum


def _check(xh, dt, A, Bp, Cp) -> None:
    """What the CUDA kernel takes: one device; x, B, C f32 or bf16 alike;
    dt and A f32; contiguous; hp in HEAD_DIMS; N a multiple of 4 up to 128."""
    name = "ssd_intra"
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    if xh.dtype not in DTYPE_CODES or Bp.dtype != xh.dtype \
            or Cp.dtype != xh.dtype:
        raise TypeError(f"{name}: x, B, C dtypes {xh.dtype}, {Bp.dtype}, "
                        f"{Cp.dtype} (all float32 or all bfloat16)")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32")
    if (dt.shape != (b, s, nh) or A.shape != (nh,) or Bp.shape != (b, s, n)
            or Cp.shape != Bp.shape):
        raise ValueError(f"{name}: shapes x {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bp.shape)}, C {tuple(Cp.shape)}")
    if hp not in HEAD_DIMS or n % 4 or not 0 < n <= MAX_STATE or s == 0:
        raise ValueError(f"{name}: head_dim {hp} (one of {HEAD_DIMS}), "
                         f"d_state {n} (a multiple of 4 up to {MAX_STATE}), "
                         f"S {s}")
    for t in (xh, dt, A, Bp, Cp):
        if t.device != xh.device:
            raise ValueError(f"{name}: tensors on {t.device} and {xh.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")


def ssd_intra(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bp: torch.Tensor, Cp: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, ...]:
    """(y_intra, s_chunk, decay, cum) as ``ssd_intra_plain``.  A CUDA tensor goes
    to the kernel or raises; only a tensor that lies elsewhere (CPU, meta)
    takes the plain version."""
    if xh.device.type != "cuda":
        return ssd_intra_plain(xh, dt, A, Bp, Cp, chunk)
    _check(xh, dt, A, Bp, Cp)
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nc, _ = chunking(s, chunk)
    lib = build.load()
    y = torch.empty((b, s, nh, hp), dtype=torch.float32, device=xh.device)
    s_chunk = torch.empty((b, nc, nh, hp, n), dtype=torch.float32,
                          device=xh.device)
    decay = torch.empty((b, nc, nh), dtype=torch.float32, device=xh.device)
    cum = torch.empty((b, nc, q, nh), dtype=torch.float32, device=xh.device)
    with torch.cuda.device(xh.device):
        err = lib.rt_ssd_intra(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bp.data_ptr(),
            Cp.data_ptr(), y.data_ptr(), s_chunk.data_ptr(), decay.data_ptr(),
            cum.data_ptr(), b, s, nh, hp, n, q, DTYPE_CODES[xh.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "ssd_intra")
    ssd_intra.launches += 1
    return y, s_chunk, decay, cum


ssd_intra.launches = 0            # kernel launches made by the wrapper
