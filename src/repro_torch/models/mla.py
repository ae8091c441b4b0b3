# No counterpart in src/repro: the JAX package has no latent attention.
"""Multi-head latent attention (MLA; DeepSeek-V2, arXiv:2405.04434 §2.1),
with q uncompressed, as DeepSeek-V2-Lite has it.

For a token at position t with normalised input h::

    q = h W_Q                   [H, dn + dr]: q_nope | q_pe, q_pe roped
    [c | k_pe] = h W_KVA        c [r] RMS-normalised; k_pe [dr] roped, one
                                for all heads
    cache[t] = [c | k_pe]       r + dr values a layer
    prefill (expanded):  [k_nope | v]_h = c W_KVB[h];  k_h = [k_nope_h | k_pe]
                         o_h = softmax(s q_h . k_h) v_h
    decode (absorbed):   q_lat_h = q_nope_h W_UK[h]^T (r wide)
                         score_hj = s (q_lat_h . c_j + q_pe_h . k_pe_j)
                         o_h = (sum_j p_hj c_j) W_UV[h]
    out = concat_h(o_h) W_O

W_UK and W_UV are the k_nope and v halves of W_KVB ([r, H, dn + dv]).  The
rope is YaRN's (`yarn_inv_freq`) over the pairs (2i, 2i + 1) of the roped
widths, as published; the scale s is (dn + dr)^-1/2 times YaRN's mscale
squared (`softmax_scale`).  The prefill runs the expanded form through K1
(``kernels/flash_attention.py``, qk 192 and v 128 in bf16); a decode step the
absorbed form through the latent-decode kernel (``kernels/mla_decode.py``;
its plain version where ``attention_impl`` is ``"reference"`` or
``"chunked"``), the two per-head products to and from the latent as batched
products (``nugget_block_attn.absorb``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.kernels import mla_decode as MD
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec

KV_NORM_EPS = 1e-6        # the latent's RMSNorm (DeepseekV2RMSNorm's default)


def mla_specs(cfg: ArchConfig) -> Dict[str, Any]:
    m, h, d = cfg.mla, cfg.attn.n_heads, cfg.d_model
    return {
        "wq": {"kernel": ParamSpec((d, h, m.qk_head_dim),
                                   ("embed", "heads", "head_dim"), "scaled")},
        "wkv_a": {"kernel": ParamSpec((d, m.latent_dim), ("embed", None),
                                      "scaled")},
        "kv_norm": {"scale": ParamSpec((m.kv_lora_rank,), (None,), "ones")},
        "wkv_b": {"kernel": ParamSpec(
            (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
            (None, "heads", "head_dim"), "scaled")},
        "wo": {"kernel": ParamSpec((h, m.v_head_dim, d),
                                   ("heads", "head_dim", "embed"), "scaled")},
    }


# ---------------------------------------------------------------------------
# YaRN rope
# ---------------------------------------------------------------------------


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(m: MLAConfig, theta: float) -> Tuple[int, int]:
    """(low, high): the rope pairs below ``low`` keep their frequency, those
    from ``high`` on are divided by the factor, a linear ramp between."""
    dim = m.qk_rope_head_dim

    def corr(n_rot: float) -> float:
        return (dim * math.log(m.original_max_position / (n_rot * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(corr(m.beta_fast))
    high = math.ceil(corr(m.beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(m: MLAConfig, theta: float, device=None) -> torch.Tensor:
    """[dr / 2] f32: each rope pair's frequency, interpolated by YaRN's ramp
    between the extrapolated (base) and the interpolated (base / factor)."""
    dim = m.qk_rope_head_dim
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim)
    if m.rope_factor <= 1:
        return extra
    low, high = yarn_correction_range(m, theta)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return extra / m.rope_factor * ramp + extra * (1 - ramp)


def softmax_scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    s = m.qk_head_dim ** -0.5
    if m.rope_factor > 1 and m.mscale_all_dim:
        s *= yarn_mscale(m.rope_factor, m.mscale_all_dim) ** 2
    return s


def rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    """(cos, sin), each [..., S, 1, dr/2] f32 for positions broadcastable to
    [..., S], times YaRN's cos/sin factor (mscale over mscale_all_dim)."""
    m = cfg.mla
    ang = (positions[..., None].float()
           * yarn_inv_freq(m, cfg.attn.rope_theta, positions.device))
    k = (yarn_mscale(m.rope_factor, m.mscale)
         / yarn_mscale(m.rope_factor, m.mscale_all_dim))
    ang = ang[..., None, :]
    return torch.cos(ang) * k, torch.sin(ang) * k


def apply_rope_pairs(x: torch.Tensor, tables) -> torch.Tensor:
    """x [..., S, H, dr]: the pairs (2i, 2i + 1) rotated by angle i."""
    cos, sin = tables
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def project(p, cfg: ArchConfig, h: torch.Tensor, rope, dtype):
    """h [B, S, d] -> (q_nope [B, S, H, dn], q_pe [B, S, H, dr] roped,
    latent [B, S, r + dr]: the normalised latent and the roped key)."""
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", h.to(dtype),
                     L.get_kernel(p["wq"], dtype))
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    kv = h.to(dtype) @ L.get_kernel(p["wkv_a"], dtype)
    c, k_pe = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c = L.rmsnorm(p["kv_norm"], c, KV_NORM_EPS)
    k_pe = apply_rope_pairs(k_pe[..., None, :], rope)[..., 0, :]
    return q_nope, apply_rope_pairs(q_pe, rope), torch.cat([c, k_pe], dim=-1)


def attend_expanded(p, cfg: ArchConfig, q_nope, q_pe, latent,
                    dtype) -> torch.Tensor:
    """The prefill's attention over the sequence's own latents, expanded to
    per-head keys and values: [B, S, H, dv]."""
    m, h = cfg.mla, cfg.attn.n_heads
    c, k_pe = latent.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    kvb = torch.einsum("bsr,rhk->bshk", c, L.get_kernel(p["wkv_b"], dtype))
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, h, -1)], dim=-1)
    pos = torch.arange(q.shape[1], device=q.device)[None].expand(
        q.shape[0], -1)
    return A.attend(cfg.attention_impl, q, k, v.contiguous(), pos, pos,
                    A.HeadLayout.make(cfg.attn, 1), causal=True, window=-1,
                    q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk,
                    scale=softmax_scale(cfg))


def out_proj(p, ctx: torch.Tensor, dtype) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", ctx.to(dtype),
                        L.get_kernel(p["wo"], dtype))


def decode_attend(impl: str):
    """The absorbed attention of ``attention_impl``: the latent-decode
    kernel for ``"cuda"`` (its plain version off the card), the plain
    version for ``"reference"`` and ``"chunked"``."""
    if impl == "cuda":
        return MD.mla_decode
    if impl in ("reference", "chunked"):
        return MD.mla_decode_plain
    raise ValueError(f"unknown attention impl {impl!r}")


def attend_absorbed(p, cfg: ArchConfig, q_nope, q_pe, cache_l, lengths,
                    dtype) -> torch.Tensor:
    """A decode step's attention over the latent cache [B, S, r + dr]
    (``lengths`` [B]: keys in range, this token included), in the absorbed
    form: [B, 1, H, dv]."""
    m = cfg.mla
    w = L.get_kernel(p["wkv_b"], dtype)                    # [r, H, dn + dv]
    w_uk = w[..., :m.qk_nope_head_dim].permute(1, 2, 0)   # [H, dn, r]
    w_uv = w[..., m.qk_nope_head_dim:].transpose(0, 1)    # [H, r, dv]
    with L.scope("nugget_block_attn.absorb"):
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)   # [H, B, r]
        q_full = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
    with L.scope("nugget_block_attn.attend"):
        ctx = decode_attend(cfg.attention_impl)(
            q_full.contiguous(), cache_l, lengths, scale=softmax_scale(cfg),
            latent=m.kv_lora_rank)
    with L.scope("nugget_block_attn.absorb"):
        o = torch.bmm(ctx.transpose(0, 1), w_uv)                # [H, B, dv]
    return o.transpose(0, 1)[:, None]
