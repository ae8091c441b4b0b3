# Counterpart of src/repro/models/encdec.py; nothing of it is left unported.
# Differences: the encoder's and the decoder prefill's self-attention go
# through `attention_impl` ("cuda": K1, non-causal in the encoder, causal in
# the decoder), and the decode step's through K2 (the reference's
# `attend_decode` is its plain softmax); the cache is updated in place; the
# decode step writes through `decode._write_index` (an idle slot's length
# passes the cache) and clamps the `dec_pos` row it reads, where the
# reference's `jnp.take` fills an out-of-range row with NaN (idle rows only).
# The `shard(...)` constraints are identities unless a plan is active and the
# tensor is a DTensor.
# An int8 cache is refused (`transformer.require_ported`).
"""Whisper-style encoder-decoder backbone (the audio frontend is a stub: the
caller feeds precomputed frame embeddings [B, n_frames, d_model]).
LayerNorm + GELU + learned positions, encoder self-attention (full),
decoder self-attention (causal, cached) + cross-attention (cached k/v of the
encoder's output).

The cross-attention stays the plain quadratic softmax (`attend_reference`),
as in the reference, which computes it outside any kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, dtype_of
from repro_torch.distributed.sharding import shard
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.decode import _write_index, _write_kv
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import (ModelDims, _aux_zero,
                                            positions_for, require_ported,
                                            unstack)


def layernorm_specs(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), "ones"),
            "bias": ParamSpec((d,), ("embed",), "zeros")}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 inside, cast back to the input's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def _enc_layer_specs(cfg: ArchConfig, dims: ModelDims) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "attn_norm": layernorm_specs(d),
        "attn": A.attention_specs(cfg.attn, d, dims.layout),
        "mlp_norm": layernorm_specs(d),
        "mlp": L.mlp_specs(d, cfg.d_ff, glu=False),
    }


def _dec_layer_specs(cfg: ArchConfig, dims: ModelDims) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "attn_norm": layernorm_specs(d),
        "attn": A.attention_specs(cfg.attn, d, dims.layout),
        "xattn_norm": layernorm_specs(d),
        "xattn": A.attention_specs(cfg.attn, d, dims.layout),
        "mlp_norm": layernorm_specs(d),
        "mlp": L.mlp_specs(d, cfg.d_ff, glu=False),
    }


def encdec_specs(cfg: ArchConfig, dims: ModelDims) -> Dict[str, Any]:
    return {
        "embed": {"embedding": ParamSpec((dims.vocab_pad, cfg.d_model),
                                         ("vocab", "embed"), "normal", 1.0)},
        "dec_pos": ParamSpec((cfg.max_seq_len, cfg.d_model), (None, "embed"),
                             "normal", 0.5),
        "enc_pos": ParamSpec((cfg.n_frames, cfg.d_model), (None, "embed"),
                             "normal", 0.5),
        "enc_layers": L.stack_specs(_enc_layer_specs(cfg, dims),
                                    cfg.n_enc_layers),
        "dec_layers": L.stack_specs(_dec_layer_specs(cfg, dims), cfg.n_layers),
        "enc_norm": layernorm_specs(cfg.d_model),
        "final_norm": layernorm_specs(cfg.d_model),
    }


def _self_attn(p, cfg, dims, x, positions, *, causal, dt):
    q, k, v = A.qkv(p, cfg.attn, dims.layout, x, positions, dt, rope=False)
    ctx = A.attend(cfg.attention_impl, q, k, v, positions, positions,
                   dims.layout, causal=causal, window=-1,
                   q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    return A.out_proj(p, dims.layout, ctx, dt), (k, v)


def enc_layer(p, cfg, dims, x, positions, dt):
    """One encoder layer: non-causal self-attention, GELU MLP."""
    h = layernorm(p["attn_norm"], x)
    y, _ = _self_attn(p["attn"], cfg, dims, h, positions, causal=False, dt=dt)
    x = x + y
    h = layernorm(p["mlp_norm"], x)
    return x + L.mlp(p["mlp"], h, "gelu", dt)


def encode(params, cfg: ArchConfig, dims: ModelDims, frames) -> torch.Tensor:
    """frames: [B, n_frames, d_model] stub embeddings."""
    dt = dtype_of(cfg.compute_dtype)
    x = frames.to(dt) + params["enc_pos"].to(dt)[None]
    x = shard(x, "batch", "seq", "act_embed")
    positions = positions_for(x[..., 0])
    for p in unstack(params["enc_layers"], cfg.n_enc_layers):
        x = enc_layer(p, cfg, dims, x, positions, dt)
    return layernorm(params["enc_norm"], x)


def _cross_kv(p, cfg, dims, enc_out, dt):
    k = A._proj(p["wk"], enc_out, ("batch", None, None, None), dt)
    v = A._proj(p["wv"], enc_out, ("batch", None, None, None), dt)
    if dims.layout.repeat > 1:
        k = torch.repeat_interleave(k, dims.layout.repeat, dim=2)
        v = torch.repeat_interleave(v, dims.layout.repeat, dim=2)
    return k, v


def _cross_attend(p, cfg, dims, x, k, v, dt):
    q = A._proj(p["wq"], x, ("batch", "seq", "act_heads", None), dt)
    q_pos = positions_for(q[..., 0, 0])
    k_pos = positions_for(k[..., 0, 0])
    ctx = A.attend_reference(q, k, v, q_pos, k_pos, dims.layout,
                             causal=False, window=-1)
    return A.out_proj(p, dims.layout, ctx, dt)


def dec_layer(p, cfg, dims, x, positions, enc_out, dt):
    """One decoder layer over a whole sequence: causal self-attention,
    cross-attention to ``enc_out``, GELU MLP.  Returns (x, (k, v), (cross
    k, cross v))."""
    h = layernorm(p["attn_norm"], x)
    y, kv = _self_attn(p["attn"], cfg, dims, h, positions, causal=True, dt=dt)
    x = x + y
    h = layernorm(p["xattn_norm"], x)
    ck, cv = _cross_kv(p["xattn"], cfg, dims, enc_out, dt)
    x = x + _cross_attend(p["xattn"], cfg, dims, h, ck, cv, dt)
    h = layernorm(p["mlp_norm"], x)
    return x + L.mlp(p["mlp"], h, "gelu", dt), kv, (ck, cv)


def _embed_target(params, cfg, dims, tokens, dt):
    s = tokens.shape[1]
    x = L.embed_lookup(params["embed"], tokens, dt)
    x = x + params["dec_pos"][:s].to(dt)[None]
    return shard(x, "batch", "seq", "act_embed")


def _logits(params, cfg, dims, x, dt, *, mask: bool = True):
    logits = L.unembed(params["embed"], x, dt)
    if mask and dims.vocab_pad > cfg.vocab_size:
        ok = torch.arange(dims.vocab_pad, device=x.device) < cfg.vocab_size
        logits = torch.where(ok[None, None], logits, -1e30)
    return shard(logits, "batch", "seq", "act_vocab")


def encdec_forward(params, cfg: ArchConfig, dims: ModelDims, tokens,
                   frames) -> Tuple[torch.Tensor, Dict]:
    """Training forward: encode frames, decode the full target sequence."""
    require_ported(cfg)
    dt = dtype_of(cfg.compute_dtype)
    enc_out = encode(params, cfg, dims, frames)
    positions = positions_for(tokens)
    x = _embed_target(params, cfg, dims, tokens, dt)
    for p in unstack(params["dec_layers"], cfg.n_layers):
        x = dec_layer(p, cfg, dims, x, positions, enc_out, dt)[0]
    x = layernorm(params["final_norm"], x)
    return _logits(params, cfg, dims, x, dt), _aux_zero(cfg, x.device)


def encdec_prefill(params, cfg: ArchConfig, dims: ModelDims, tokens, frames,
                   cache: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Dict]:
    """Encode + run the prompt through the decoder, filling the self and
    cross caches in place; returns the last position's logits (unmasked,
    as the reference's)."""
    require_ported(cfg)
    dt = dtype_of(cfg.compute_dtype)
    enc_out = encode(params, cfg, dims, frames)
    s = tokens.shape[1]
    positions = positions_for(tokens)
    x = _embed_target(params, cfg, dims, tokens, dt)
    for i, p in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        x, (k, v), (ck, cv) = dec_layer(p, cfg, dims, x, positions, enc_out,
                                        dt)
        cache["k"][i, :, :s].copy_(k)
        cache["v"][i, :, :s].copy_(v)
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
    cache["length"].fill_(s)
    x = layernorm(params["final_norm"], x[:, -1:])
    return (_logits(params, cfg, dims, x, dt, mask=False), cache,
            _aux_zero(cfg, x.device))


def encdec_decode(params, cfg: ArchConfig, dims: ModelDims, token,
                  cache: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, Any], Dict]:
    """One decode step: the new token's self k/v written at each row's
    length (through K2 with ``attention_impl="cuda"``), cross-attention to
    the cached encoder k/v."""
    require_ported(cfg)
    dt = dtype_of(cfg.compute_dtype)
    lengths = cache["length"]
    positions = lengths[:, None]
    pos_row = lengths.long().clamp(0, params["dec_pos"].shape[0] - 1)
    x = L.embed_lookup(params["embed"], token, dt)
    # the rows' positions gathered as tokens are (`lookup_rows` on DTensors)
    x = x + L.embed_lookup({"embedding": params["dec_pos"]}, pos_row,
                           dt)[:, None, :]
    attend_len = lengths + 1                         # includes this token
    index = _write_index(lengths, cache["k"][0])
    for i, p in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        h = layernorm(p["attn_norm"], x)
        q, k, v = A.qkv(p["attn"], cfg.attn, dims.layout, h, positions, dt,
                        rope=False)
        k_l, v_l = _write_kv(cache["k"][i], cache["v"][i], k, v, lengths,
                             index)
        ctx = A.attend_decode(q, k_l, v_l, attend_len, dims.layout,
                              window=-1, impl=cfg.attention_impl)
        x = x + A.out_proj(p["attn"], dims.layout, ctx, dt)
        h = layernorm(p["xattn_norm"], x)
        x = x + _cross_attend(p["xattn"], cfg, dims, h, cache["cross_k"][i],
                              cache["cross_v"][i], dt)
        h = layernorm(p["mlp_norm"], x)
        x = x + L.mlp(p["mlp"], h, "gelu", dt)
    lengths.add_(1)            # every row, active or not, as the reference
    x = layernorm(params["final_norm"], x)
    return _logits(params, cfg, dims, x, dt), cache, _aux_zero(cfg, x.device)
