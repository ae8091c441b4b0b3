# Counterpart of src/repro/kernels/ops.py.  Nothing of it is left unported.
# `ssd`'s inter-chunk recurrence is a Python loop over chunks where the
# reference has a `lax.scan` (outside the kernel in both).
"""Model-facing wrappers of the kernels.

``ssd`` composes the intra-chunk kernel (K3) with the cheap inter-chunk
recurrence and the C·h_in inter-chunk output term."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode
from repro_torch.kernels.ssd import chunking, ssd_intra


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, group: int,
                    causal: bool = True, window=None, cap: float = 0.0,
                    scale=None) -> torch.Tensor:
    """Model-facing signature (positions are arange; rope pre-applied)."""
    return _flash(q, k, v, group=group, causal=causal, window=window, cap=cap,
                  scale=scale)


def flash_decode(q, k_cache, v_cache, lengths, *, group: int, window=None,
                 cap: float = 0.0) -> torch.Tensor:
    return _flash_decode(q, k_cache, v_cache, lengths, group=group,
                         window=window, cap=cap)


def ssd(xh, dt, A, Bp, Cp, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SSD layer: K3 for the intra-chunk tiles, then the recurrence
    ``h ← decay·h + s_chunk`` over chunks, adding ``C·h_in·exp(cum)``.
    Returns (y [B,S,nh,hp] f32, h_final [B,nh,hp,N] f32)."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nc, _ = chunking(s, chunk)
    y, s_chunk, dec, cum = ssd_intra(xh, dt, A, Bp, Cp, chunk)
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=xh.device)
    for c in range(nc):
        if c:             # h is 0 before the first chunk
            lo, hi = c * q, min((c + 1) * q, s)
            # [b,1,m,n] @ [b,nh,n,hp] -> [b,nh,m,hp], times exp(cum)
            y_inter = torch.matmul(Cp[:, None, lo:hi].float(),
                                   h.transpose(-1, -2))
            y[:, lo:hi] += y_inter.permute(0, 2, 1, 3) * \
                torch.exp(cum[:, c, :hi - lo])[..., None]
        h = dec[:, c, :, None, None] * h + s_chunk[:, c]
    return y, h
