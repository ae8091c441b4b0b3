# Counterpart of src/repro/models/attention.py; nothing of it is left
# unported.  `attend` with "pallas" raises (the port's kernel is "cuda"), and
# `attend_decode` takes the kernel or the plain version by `impl` ("chunked"
# decodes as "reference": the reference's decode is that plain softmax).
# The `shard(...)` constraints are identities unless a plan is active and
# the tensor is a DTensor (distributed/sharding.py); under a plan the
# projections are `sharded_product`s and the attention core runs per rank.
# The port's own: `attend` takes a `scale` where the scores' factor is not
# head_dim^-1/2, and values narrower than the keys (latent attention's
# expanded prefill, `models/mla.py`).
"""GQA attention: reference (quadratic), chunked (streaming softmax in plain
PyTorch, the training path's) and cuda (the hand-written kernels).

Head padding.  The parameter layout pads q heads up to a multiple of the
tensor-parallel size and expands kv heads by replication slots; pad heads are
zero-initialised and **masked out of the output**.  On one device tp = 1, so
``h_pad = n_heads``, ``kv_pad = n_kv`` and ``repeat = 1``; the general code is
kept so that the layout stays the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import AttnConfig
from repro_torch.distributed.sharding import (from_local_part, local_part,
                                              shard, sharded_product)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import gqa_out, gqa_scores
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec

NEG_INF = -1e30       # masked scores are finite: a fully masked row is mean(V)

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    n_heads: int          # real q heads
    n_kv: int             # real kv heads
    h_pad: int            # padded q slots (divisible by tp)
    kv_pad: int           # padded kv slots (divisible by tp, divides h_pad)
    repeat: int           # kv replication factor kv_pad / n_kv
    head_dim: int

    @staticmethod
    def make(a: AttnConfig, tp: int) -> "HeadLayout":
        h, kv = a.n_heads, a.n_kv_heads
        assert h % kv == 0, (h, kv)
        # smallest integer replication r with tp | kv*r (exact kv copies)
        r = tp // math.gcd(kv, tp)
        kv_pad = kv * r
        lcm = tp * kv_pad // math.gcd(tp, kv_pad)
        h_pad = lcm * math.ceil(max(h, 1) / lcm)
        return HeadLayout(h, kv, h_pad, kv_pad, r, a.head_dim)

    @property
    def group(self) -> int:            # q slots per kv slot
        return self.h_pad // self.kv_pad

    @property
    def g_real(self) -> int:           # q slots per REAL kv head
        return self.h_pad // self.n_kv

    def head_mask(self) -> np.ndarray:
        """[h_pad] 1.0 for real q heads, 0.0 for structural padding."""
        real_per_group = self.n_heads // self.n_kv
        s = np.arange(self.h_pad)
        return ((s % self.g_real) < real_per_group).astype(np.float32)

    @property
    def n_pad(self) -> int:
        return self.h_pad - self.n_heads


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attention_specs(a: AttnConfig, d: int, layout: HeadLayout) -> Dict[str, Any]:
    hd = a.head_dim
    kv_axes = (("embed", "kv_heads", "head_dim") if layout.repeat == 1
               else ("embed", None, None))
    mask = layout.head_mask()

    def q_init(gen, shape, device):
        w = 0.02 * L.normal(gen, shape, device)
        m = torch.as_tensor(mask, device=device)
        # zero the pad-head columns; the head axis is third from the end
        # whether or not a stacked layer axis leads
        return w * m[:, None]

    specs: Dict[str, Any] = {
        "wq": {"kernel": ParamSpec((d, layout.h_pad, hd),
                                   ("embed", "heads", "head_dim"),
                                   init_fn=q_init)},
        "wk": {"kernel": ParamSpec((d, layout.n_kv, hd), kv_axes, "scaled")},
        "wv": {"kernel": ParamSpec((d, layout.n_kv, hd), kv_axes, "scaled")},
        "wo": {"kernel": ParamSpec((layout.h_pad, hd, d),
                                   ("heads", "head_dim", "embed"), "scaled")},
    }
    if a.qkv_bias:
        specs["wq"]["bias"] = ParamSpec((layout.h_pad, hd),
                                        ("heads", "head_dim"), "zeros")
        specs["wk"]["bias"] = ParamSpec((layout.n_kv, hd),
                                        (kv_axes[1], kv_axes[2]), "zeros")
        specs["wv"]["bias"] = ParamSpec((layout.n_kv, hd),
                                        (kv_axes[1], kv_axes[2]), "zeros")
    if a.qk_norm:
        specs["q_norm"] = {"scale": ParamSpec((hd,), (None,), "ones")}
        specs["k_norm"] = {"scale": ParamSpec((hd,), (None,), "ones")}
    return specs


def _proj(p, x, heads_axes, dtype):
    w = L.get_kernel(p, dtype)
    y = (sharded_product(x.to(dtype), w) if isinstance(w, DTensor)
         else torch.einsum("bsd,dhk->bshk", x.to(dtype), w))
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return shard(y, *heads_axes)


def qkv(params, a: AttnConfig, layout: HeadLayout, x: torch.Tensor,
        positions: torch.Tensor, dtype, *, rope: bool = True,
        kv_x=None, kv_positions=None, rope_tables=None):
    """Project to padded-slot q and kv-slot k/v, applying qk-norm + RoPE.
    ``kv_x``/``kv_positions``: the keys' source and positions where they are
    not the queries' (cross-attention); ``rope=False`` skips the rotation
    (the enc-dec family's learned positions).  ``rope_tables``:
    `layers.rope_tables(positions, ...)` made once by a caller that runs many
    layers at the same positions (used for k only at those positions)."""
    kv_x = x if kv_x is None else kv_x
    q = _proj(params["wq"], x, ("batch", "seq", "act_heads", None), dtype)
    k = _proj(params["wk"], kv_x, ("batch", "seq", None, None), dtype)
    v = _proj(params["wv"], kv_x, ("batch", "seq", None, None), dtype)
    if a.qk_norm:                       # before rope
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    if rope:
        q = L.apply_rope(q, positions, a.rope_theta, rope_tables)
        if kv_positions is None:
            k = L.apply_rope(k, positions, a.rope_theta, rope_tables)
        else:
            k = L.apply_rope(k, kv_positions, a.rope_theta)
    if layout.repeat > 1:
        k = torch.repeat_interleave(k, layout.repeat, dim=2)
        v = torch.repeat_interleave(v, layout.repeat, dim=2)
    k = shard(k, "batch", "kv_seq", "act_heads", None)
    v = shard(v, "batch", "kv_seq", "act_heads", None)
    return q, k, v


def out_proj(params, layout: HeadLayout, ctx: torch.Tensor,
             dtype) -> torch.Tensor:
    if layout.n_pad:                    # kill structural pad heads
        mask = torch.as_tensor(layout.head_mask(), dtype=dtype,
                               device=ctx.device)
        ctx = ctx * mask[None, None, :, None]
    w = L.get_kernel(params["wo"], dtype)
    if isinstance(w, DTensor):          # the heads and head_dim contracted
        y = sharded_product(ctx.to(dtype).flatten(2), w.flatten(0, 1))
    else:
        y = torch.einsum("bshk,hkd->bsd", ctx.to(dtype), w)
    return shard(y, "batch", "seq", "act_embed")


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, window, causal: bool):
    """Additive mask bias [..., Sq, Sk].  window: int or int tensor, <0 =
    global."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok = ok & (d >= 0)
    if isinstance(window, torch.Tensor):
        ok = ok & ((window < 0) | (d < window))
    elif window is not None and window >= 0:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, NEG_INF)

# ---------------------------------------------------------------------------
# Core attention impls (q: [B,Sq,Hp,hd], k/v: [B,Sk,KVp,hd])
# ---------------------------------------------------------------------------


def _gqa_scores(q, k, group: int, scale=None):
    """-> [B, KVp, G, Sq, Sk] in f32, times ``scale`` (default hd^-1/2)."""
    if scale is not None:
        return gqa_scores(q, k, group) * scale
    return gqa_scores(q, k, group) / math.sqrt(q.shape[-1])


def _gqa_out(probs, v, hp: int):
    return gqa_out(probs, v)


def attend_reference(q, k, v, q_pos, k_pos, layout: HeadLayout, *,
                     causal: bool, window, cap: float = 0.0,
                     kv_len=None, scale=None) -> torch.Tensor:
    """The quadratic softmax.  ``kv_len`` ([B] or broadcastable to k_pos's
    batch axis): keys at positions >= kv_len are masked (empty cache
    slots).  ``scale``: the scores' factor where it is not hd^-1/2."""
    scores = _gqa_scores(q, k, layout.group, scale)
    scores = L.softcap(scores, cap)
    bias = _mask_bias(q_pos, k_pos, window, causal)
    if kv_len is not None:              # decode: mask empty cache slots
        bias = bias + torch.where(k_pos < kv_len, 0.0, NEG_INF)[..., None, :]
    scores = scores + bias[:, None, None] if bias.ndim == 3 else scores + bias
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v, layout.h_pad).to(q.dtype)


def attend_chunked(q, k, v, q_pos, k_pos, layout: HeadLayout, *,
                   causal: bool, window, cap: float = 0.0,
                   q_chunk: int = 1024, kv_chunk: int = 1024,
                   causal_skip: bool = False, scale=None) -> torch.Tensor:
    """Streaming-softmax (flash-style) attention in plain PyTorch.  Exact,
    and differentiable by autograd: it is the attention of the train step.

    Loops over q blocks; for each q block loops over kv blocks carrying the
    running (max, denom, acc).  Pad positions are -1 (q) and 2**30 (k), so
    the mask removes them.  ``causal_skip`` stops each q block's loop at the
    causal frontier (removes the ~2x masked FLOPs of the dense schedule).
    Without it every q block walks every kv block, so the q blocks go as one
    (each row's arithmetic is a q block's; the reference's q loop is
    unrolled too): the same FLOPs and values in ``nq`` times fewer calls.
    v may be narrower than q and k (latent attention's expanded prefill);
    ``scale``: the scores' factor where it is not hd^-1/2."""
    b, sq, hp, _ = q.shape
    hd = v.shape[-1]
    sk = k.shape[1]
    qc, kc = min(q_chunk, sq), min(kv_chunk, sk)
    nq, nk = -(-sq // qc), -(-sk // kc)
    pad_q, pad_k = nq * qc - sq, nk * kc - sk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = F.pad(k_pos, (0, pad_k), value=2 ** 30)
    g = layout.group
    n = hp // g

    def q_block(qi: int, kv_hi: int) -> torch.Tensor:
        qs = q[:, qi * qc:(qi + 1) * qc]
        qp = q_pos[:, qi * qc:(qi + 1) * qc]
        m = torch.full((b, n, g, qc), -math.inf, device=q.device)
        l = torch.zeros((b, n, g, qc), device=q.device)
        acc = torch.zeros((b, n, g, qc, hd), device=q.device)
        for j in range(kv_hi):
            kj = k[:, j * kc:(j + 1) * kc]
            vj = v[:, j * kc:(j + 1) * kc]
            s = _gqa_scores(qs, kj, g, scale)            # [b,n,g,qc,kc]
            s = L.softcap(s, cap)
            s = s + _mask_bias(qp, k_pos[:, j * kc:(j + 1) * kc], window,
                               causal)[:, None, None]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            pv = torch.matmul(p.reshape(b, n, g * qc, kc),
                              vj.float().permute(0, 2, 1, 3))
            acc = acc * alpha[..., None] + pv.reshape(b, n, g, qc, hd)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out = acc / l[..., None]                         # [b,n,g,qc,hd]
        return out.permute(0, 3, 1, 2, 4).reshape(b, qc, hp, hd)

    if causal_skip and causal:
        outs = [q_block(i, min(nk, ((i + 1) * qc - 1) // kc + 1))
                for i in range(nq)]
    else:
        qc = nq * qc                    # read by q_block
        outs = [q_block(0, nk)]
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def attend_decode_plain(q, k_cache, v_cache, cache_len, layout: HeadLayout, *,
                        window, cap: float = 0.0) -> torch.Tensor:
    """The reference's `attend_decode`: a plain masked softmax over the
    whole cache.  Kept as the oracle of the decode kernel at this level."""
    b, s, kvp, hd = k_cache.shape
    k_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None].expand(b, s)
    cur = (cache_len[:, None] if cache_len.ndim == 1 else cache_len) - 1
    scores = _gqa_scores(q, k_cache, layout.group)       # [B,KVp,G,1,S]
    scores = L.softcap(scores, cap)
    d = cur[..., :, None] - k_pos[..., None, :]          # [B,1,S]; cur = query pos
    ok = d >= 0                                          # excludes empty slots
    if isinstance(window, torch.Tensor):
        ok = ok & ((window < 0) | (d < window))
    elif window is not None and window >= 0:
        ok = ok & (d < window)
    bias = torch.where(ok, 0.0, NEG_INF)
    scores = scores + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v_cache, layout.h_pad).to(q.dtype)


def attend_decode(q, k_cache, v_cache, cache_len, layout: HeadLayout, *,
                  window, cap: float = 0.0,
                  impl: str = "cuda") -> torch.Tensor:
    """Single-token decode over a KV cache.  q: [B,1,Hp,hd]; caches:
    [B,S,KVp,hd]; cache_len: [B] valid entries including the current token.

    In the JAX package this is a plain masked softmax that the SPMD
    partitioner turns into flash-decode partials over a sharded cache.  On
    one GPU nothing builds them, so with ``impl="cuda"`` this **is** the
    flash-decode kernel (its plain version for a CPU tensor).  The two agree
    for ``cache_len >= 1``, which the decode step guarantees.  "chunked"
    (the training impl) decodes as "reference" does: the reference's decode
    is that masked softmax whatever its config's impl.

    DTensor inputs attend on this rank's rows and heads as plain tensors,
    as `attend` does; a cache sharded over its sequence (long_500k) is
    gathered for it (the reference's partitioner splits the softmax into
    flash-decode partials there)."""
    if isinstance(q, DTensor):
        def part(t, dims=(0, 2)):
            return local_part(t, q, dims)
        out = attend_decode(part(q), part(k_cache), part(v_cache),
                            part(cache_len, (0,)), layout, window=window,
                            cap=cap, impl=impl)
        return from_local_part(out, q, (0, 2))
    if impl in ("reference", "chunked"):
        return attend_decode_plain(q, k_cache, v_cache, cache_len, layout,
                                   window=window, cap=cap)
    if impl == "cuda":
        return kops.flash_decode(q, k_cache, v_cache, cache_len,
                                 group=layout.group, window=window, cap=cap)
    raise ValueError(f"unknown attention impl {impl!r}")


def attend(impl: str, q, k, v, q_pos, k_pos, layout, *, causal, window,
           cap=0.0, q_chunk=1024, kv_chunk=1024, causal_skip=False,
           scale=None):
    if isinstance(q, DTensor):
        # each (batch row, head) attends alone: run on this rank's rows and
        # heads (the head padding keeps a shard's q heads with their kv
        # heads), as plain tensors; DTensor cannot always fold a sharded
        # batch of heads into its batched products
        def part(t, dims=(0, 2)):
            return local_part(t, q, dims)
        out = attend(impl, part(q), part(k), part(v), part(q_pos, (0,)),
                     part(k_pos, (0,)), layout, causal=causal,
                     window=window, cap=cap, q_chunk=q_chunk,
                     kv_chunk=kv_chunk, causal_skip=causal_skip, scale=scale)
        return from_local_part(out, q, (0, 2))
    if impl == "reference":
        return attend_reference(q, k, v, q_pos, k_pos, layout,
                                causal=causal, window=window, cap=cap,
                                scale=scale)
    if impl == "chunked":
        return attend_chunked(q, k, v, q_pos, k_pos, layout, causal=causal,
                              window=window, cap=cap, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, causal_skip=causal_skip,
                              scale=scale)
    if impl == "cuda":
        return kops.flash_attention(q, k, v, q_pos, k_pos,
                                    group=layout.group, causal=causal,
                                    window=window, cap=cap, scale=scale)
    if impl == "pallas":
        raise NotImplementedError(
            "attention impl 'pallas' is the JAX package's TPU kernel; the "
            "port has 'cuda' (its Hopper counterpart), 'chunked' and "
            "'reference'")
    raise ValueError(f"unknown attention impl {impl!r}")
