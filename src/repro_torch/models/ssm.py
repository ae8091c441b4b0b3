# Counterpart of src/repro/models/ssm.py; nothing of it is left unported.
# The `shard(...)` constraints are identities unless a plan is active and the
# tensor is a DTensor (distributed/sharding.py).  On DTensors the SSD and the
# decode step's state update run on this rank's rows and heads as plain
# tensors (each (row, head) is independent), as the attention core does:
# DTensor would fold a sharded batch of heads into its batched products.  Each
# `lax.scan` is a Python loop; the three-operand einsums of `ssd_chunked`
# are written as the pairwise products that the reference's jaxpr holds.
"""Mamba2 (state-space duality) block: chunked SSD scan, reference recurrence,
single-token decode.  B/C projections are group-shared (one group).

``cfg.ssm_impl`` chooses the full-sequence SSD: ``"cuda"`` is the
intra-chunk kernel K3 plus the inter-chunk recurrence (``kernels/ops.ssd``;
on a CPU or meta tensor K3's plain version), ``"chunked"`` and
``"reference"`` are the ports of ``ssd_chunked`` and ``ssd_reference``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (from_local_part, local_part,
                                              shard)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd import chunking, pad_steps
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec


def ssm_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


def mamba2_specs(cfg: ArchConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nh = ssm_dims(cfg)

    def a_init(gen, shape, device):
        lo, hi = s.a_init_range
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device)
        return torch.log(lo + (hi - lo) * u).to(device)

    return {
        "wz": {"kernel": ParamSpec((d, d_inner), ("embed", "ssm_inner"), "scaled")},
        "wx": {"kernel": ParamSpec((d, d_inner), ("embed", "ssm_inner"), "scaled")},
        "wB": {"kernel": ParamSpec((d, s.d_state), ("embed", None), "scaled")},
        "wC": {"kernel": ParamSpec((d, s.d_state), ("embed", None), "scaled")},
        "wdt": {"kernel": ParamSpec((d, nh), ("embed", "heads"), "scaled")},
        "dt_bias": ParamSpec((nh,), ("heads",), "zeros"),
        "A_log": ParamSpec((nh,), ("heads",), init_fn=a_init),
        "D": ParamSpec((nh,), ("heads",), "ones"),
        "conv_x": ParamSpec((s.d_conv, d_inner), (None, "ssm_inner"), "scaled"),
        "conv_B": ParamSpec((s.d_conv, s.d_state), (None, None), "scaled"),
        "conv_C": ParamSpec((s.d_conv, s.d_state), (None, None), "scaled"),
        "norm": L.rmsnorm_specs(d_inner),
        "wo": {"kernel": ParamSpec((d_inner, d), ("ssm_inner", "embed"), "scaled")},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv via shifted adds.  x: [B,S,C], w: [K,C].

    Returns (y, new_state) where state is the trailing K-1 inputs (decode).
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return F.silu(y), new_state


def _project(params, cfg, x, dtype, conv_state=None):
    s = cfg.ssm
    d_inner, nh = ssm_dims(cfg)
    z = L.dense(params["wz"], x, dtype)
    xin = L.dense(params["wx"], x, dtype)
    Bp = L.dense(params["wB"], x, dtype)
    Cp = L.dense(params["wC"], x, dtype)
    dt = L.dense(params["wdt"], x, torch.float32)
    cx, cB, cC = (None, None, None) if conv_state is None else conv_state
    xin, st_x = _causal_conv(xin, params["conv_x"].to(dtype), cx)
    Bp, st_B = _causal_conv(Bp, params["conv_B"].to(dtype), cB)
    Cp, st_C = _causal_conv(Cp, params["conv_C"].to(dtype), cC)
    dt = F.softplus(dt + params["dt_bias"].float())
    xin = shard(xin.reshape(*xin.shape[:-1], nh, s.head_dim),
                "batch", "seq", "act_heads", None)
    return z, xin, Bp, Cp, dt, (st_x, st_B, st_C)


def _finish(params, cfg, y, xh, dt_unused, z, dtype):
    d_inner, nh = ssm_dims(cfg)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(*y.shape[:-2], d_inner).to(dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(params["norm"], y, cfg.norm_eps)
    return shard(L.dense(params["wo"], y, dtype), "batch", "seq", "act_embed")


def a_of(params) -> torch.Tensor:
    """A = -exp(A_log) in f32, [nh]."""
    return -torch.exp(params["A_log"].float())


# ---------------------------------------------------------------------------
# Chunked SSD forward
# ---------------------------------------------------------------------------


def ssd_chunked(xh, dt, A, Bp, Cp, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD.  xh: [B,S,nh,hp]; dt: [B,S,nh] (f32); A: [nh] (<0);
    Bp/Cp: [B,S,N].  Returns (y [B,S,nh,hp] f32, h_final [B,nh,hp,N] f32).
    The intra-chunk products and each chunk's own state run for all chunks
    at once (the reference's scan body computes them chunk by chunk, the
    same products); only the carried state loops over the chunks."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nchunk, pad = chunking(s, chunk)
    xf = pad_steps(xh.float(), pad).reshape(b, nchunk, q, nh, hp)
    dtc = pad_steps(dt.float(), pad).reshape(b, nchunk, q, nh)
    Bc = pad_steps(Bp.float(), pad).reshape(b, nchunk, q, n)
    Cc = pad_steps(Cp.float(), pad).reshape(b, nchunk, q, n)
    la = dtc * A[None, None, None, :]                  # log decay per step
    cum = torch.cumsum(la, dim=2)                      # [b,c,q,nh]
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()

    # what does not depend on the carried state, for every chunk at once
    xdt = xf * dtc[..., None]                                  # [b,c,q,nh,hp]
    # intra-chunk: masked decay kernel L[t,s] = exp(cum_t - cum_s), t>=s
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [b,c,q,q,nh]
    # mask BEFORE exp: the upper triangle is never exponentiated
    Lk = torch.exp(torch.where(tri[None, None, :, :, None], rel, -torch.inf))
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))                # [b,c,q,q]
    # y_intra[b,c,t,h,p] = sum_s (Lk * cb)[b,c,t,s,h] xdt[b,c,s,h,p]
    w = (Lk * cb[..., None]).permute(0, 1, 4, 2, 3)            # [b,c,nh,t,s]
    y_intra = torch.matmul(w, xdt.permute(0, 1, 3, 2, 4)
                           ).permute(0, 1, 3, 2, 4)
    # each chunk's state: S_c = sum_s exp(cum_last - cum_s) B_s xdt_s
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)             # [b,c,q,nh]
    xw = (xdt * decay_out[..., None]).permute(0, 1, 3, 4, 2)   # [b,c,nh,hp,q]
    s_new = torch.matmul(xw, Bc[:, :, None])                   # [b,c,nh,hp,N]

    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0
    ys = []
    for c in range(nchunk):
        cq, cumq = Cc[:, c], cum[:, c]
        # inter-chunk contribution from incoming state:
        # C_t . h_in, times exp(cum_t)
        ch = torch.matmul(cq[:, None], h.transpose(-1, -2))        # [b,nh,q,hp]
        y_inter = ch.permute(0, 2, 1, 3) * torch.exp(cumq)[..., None]
        h = torch.exp(cumq[:, -1])[:, :, None, None] * h + s_new[:, c]
        ys.append(y_intra[:, c] + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nchunk * q, nh, hp)
    return y[:, :s], h


def ssd_reference(xh, dt, A, Bp, Cp):
    """Step-by-step recurrence oracle (f32)."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    xf, Bf, Cf = xh.float(), Bp.float(), Cp.float()
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t] * A[None])                          # [b,nh]
        dx = xf[:, t] * dt[:, t][..., None]                        # [b,nh,hp]
        h = a[..., None, None] * h + dx[..., None] * Bf[:, t, None, None, :]
        ys.append(torch.matmul(h, Cf[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def ssd(impl: str, xh, dt, A, Bp, Cp, chunk: int):
    """The full-sequence SSD by ``impl`` -> (y f32, h_final f32).  On
    DTensors it runs on this rank's rows and heads (see the head comment)."""
    if isinstance(xh, DTensor):
        y, h = ssd(impl, local_part(xh, xh, (0, 2)),
                   local_part(dt, xh, (0, 2)),
                   local_part(A[None, None], xh, (2,))[0, 0],
                   local_part(Bp, xh, (0,)), local_part(Cp, xh, (0,)), chunk)
        # h [B,nh,hp,N]: its head dim at 2, as xh's, to take xh's shards
        return (from_local_part(y, xh, (0, 2)),
                from_local_part(h[:, None], xh, (0, 2))[:, 0])
    if impl == "cuda":
        return kops.ssd(xh, dt, A, Bp, Cp, chunk=chunk)
    if impl == "chunked":
        return ssd_chunked(xh, dt, A, Bp, Cp, chunk)
    if impl == "reference":
        return ssd_reference(xh, dt, A, Bp, Cp)
    if impl == "pallas":
        raise NotImplementedError(
            "ssm impl 'pallas' is the JAX package's; the port has 'cuda' "
            "(the hand-written kernel), 'chunked' and 'reference'")
    raise ValueError(f"unknown ssm impl {impl!r}")


# ---------------------------------------------------------------------------
# Block-level entry points
# ---------------------------------------------------------------------------


def mamba2_block(params, cfg: ArchConfig, x: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence forward.  x: [B,S,d] -> [B,S,d]."""
    dtype = x.dtype
    z, xh, Bp, Cp, dt, _ = _project(params, cfg, x, dtype)
    y, _ = ssd(impl or cfg.ssm_impl, xh, dt, a_of(params), Bp, Cp,
               cfg.ssm.chunk)
    return _finish(params, cfg, y, xh, dt, z, dtype)


def mamba2_decode(params, cfg: ArchConfig, x: torch.Tensor,
                  ssm_state: torch.Tensor, conv_state: Tuple[torch.Tensor, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Single-token decode.  x: [B,1,d]; ssm_state: [B,nh,hp,N] (f32),
    **updated in place** (it is a layer of the cache) and returned."""
    dtype = x.dtype
    z, xh, Bp, Cp, dt, new_conv = _project(params, cfg, x, dtype, conv_state)
    a = torch.exp(dt[:, 0] * a_of(params)[None])           # [B,nh]
    dx = xh[:, 0].float() * dt[:, 0][..., None]             # [B,nh,hp]
    y = _decode_state(ssm_state, a, dx, Bp[:, 0].float(), Cp[:, 0].float())
    out = _finish(params, cfg, y[:, None], xh, dt, z, dtype)
    return out, ssm_state, new_conv


def _decode_state(h, a, dx, Bv, Cv):
    """h [B,nh,hp,N] <- a h + dx B (in place); returns y = h C [B,nh,hp].
    A DTensor state is updated on this rank's rows and heads."""
    if isinstance(h, DTensor):
        y = _decode_state(h.to_local(), local_part(a, h, (0, 1)),
                          local_part(dx, h, (0, 1)), local_part(Bv, h, (0,)),
                          local_part(Cv, h, (0,)))
        return from_local_part(y, h, (0, 1))
    h.mul_(a[..., None, None])
    h.addcmul_(dx[..., None], Bv[:, None, None, :])
    return torch.matmul(h, Cv[:, None, :, None])[..., 0]


def conv_dim(cfg: ArchConfig) -> int:
    d_inner, _ = ssm_dims(cfg)
    return d_inner + 2 * cfg.ssm.d_state
