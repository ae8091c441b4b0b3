# Counterpart of src/repro/models/decode.py: the dense, MoE, SSM, hybrid and
# VLM families, the int8 cache included; nothing of it is left unported.
# The `shard(...)` constraints on the written cache layers are identities
# unless a plan is active and the layer is a DTensor.  Under a plan (the
# dry-run prices a prefill and a decode step so; the engine takes no plan,
# as the JAX package's does not) a DTensor cache is written on each rank's
# own rows, heads and sequence positions (`_write_index`, `_write_kv`).
# A decode step's attention carries the block's label and its phases'
# (`layers.scope`), as the prefill's does, where the reference's decode has
# none; the prefill's copies of k/v into the cache are labelled too.
"""Prefill and single-token decode over the stacked KV / SSM caches.

The cache is **updated in place** (the JAX package returns new arrays): the
prefill copies each layer's k/v, SSM state and conv window into the cache,
the decode step writes one token per row at that row's length and updates
each layer's SSM state where it lies.  Both return the same cache object for
the reference's call shape ``logits, cache, aux``; for MoE ``aux`` holds the
router statistics summed over the layers (a decode step routes each row's
one token, at the capacity of a sequence of 1).

One deliberate difference: the reference's SSM prefill calls
``ssd_chunked`` directly; here it goes through ``cfg.ssm_impl``, so the
default prefill runs the intra-chunk kernel K3 (as the decode step's
attention is the flash-decode kernel).  The two compute the same function:
``ops.ssd`` and ``ssd_chunked`` agree within 1e-4 (tests/test_kernels.py).

With ``cache_quant="int8"`` (decoder-LM families) the prefill quantizes the
collected k/v per (token, head) into the cache, and a decode step quantizes
the new token's, then dequantizes the layer's whole cache to the compute
dtype **outside** the decode kernel, which attends over those tensors, as
the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import local_part, local_range, shard
from repro_torch.models import attention as A
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (
    ModelDims, _aux_zero, _ffn, _hybrid_groups, _mlp_block, _shared_attn_block,
    decoder_stack, embed_tokens, layer_params, positions_for, require_ported,
    rope_tables, unembed,
)


def _split_conv(cfg: ArchConfig, conv: torch.Tensor):
    d_inner, _ = S.ssm_dims(cfg)
    n = cfg.ssm.d_state
    return (conv[..., :d_inner], conv[..., d_inner:d_inner + n],
            conv[..., d_inner + n:])


def _merge_conv(parts) -> torch.Tensor:
    return torch.cat(parts, dim=-1)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _write_index(lengths: torch.Tensor, like: torch.Tensor):
    """(rows, pos, ok) of a step's per-row cache write, made once per step,
    for cache layers like ``like`` ([B, S, ...]).

    A row whose length is at or beyond the cache's capacity (a finished or
    never-used slot keeps counting) must write nothing: the reference's
    scatter drops out-of-range indices, while an out-of-range index on CUDA
    is a device-side assert.  So the position is clamped and ``ok`` marks
    the rows that really write; no host synchronisation.  On a DTensor
    cache the index is in this rank's local coordinates: its own rows, and
    the positions of its part of the sequence (a rank whose part does not
    hold a row's position writes nothing there)."""
    start, capacity = 0, like.shape[1]
    if isinstance(like, DTensor):
        start, capacity = local_range(like, 1)
        lengths = local_part(lengths, like, (0,))
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    pos = lengths.to(torch.int64) - start
    ok = ((pos >= 0) & (pos < capacity))[:, None, None]
    return rows, pos.clamp(0, capacity - 1), ok


def _write_kv(k_l, v_l, k_new, v_new, lengths, index=None):
    """Per-row write of one token's kv at each row's length, in place.
    Rows out of range keep their old value (see `_write_index`).  A DTensor
    layer is written on this rank's part, as plain tensors."""
    rows, pos, ok = _write_index(lengths, k_l) if index is None else index
    for dst, new in ((k_l, k_new), (v_l, v_new)):
        d = _local(dst)
        new = local_part(new, dst, (0, 2))[:, 0].to(d.dtype)
        d[rows, pos] = torch.where(ok, new, d[rows, pos])
    return (shard(k_l, "batch", "kv_seq", "act_heads", None),
            shard(v_l, "batch", "kv_seq", "act_heads", None))


def _write_kv_quant(k_l, v_l, ks_l, vs_l, k_new, v_new, lengths, index=None):
    """int8-cache variant of `_write_kv`: the new token's kv quantized per
    (row, head), payload and scale written in place."""
    rows, pos, ok = _write_index(lengths, k_l) if index is None else index
    for dst, scl, new in ((k_l, ks_l, k_new), (v_l, vs_l, v_new)):
        d, sl = _local(dst), _local(scl)
        q, sc = KC.quantize_kv(local_part(new, dst, (0, 2))[:, 0])
        d[rows, pos] = torch.where(ok, q, d[rows, pos])
        sl[rows, pos] = torch.where(ok[..., 0], sc, sl[rows, pos])
    return (shard(k_l, "batch", "kv_seq", "act_heads", None),
            shard(v_l, "batch", "kv_seq", "act_heads", None),
            shard(ks_l, "batch", "kv_seq", "act_heads"),
            shard(vs_l, "batch", "kv_seq", "act_heads"))


def _int8_cache(cfg: ArchConfig) -> bool:
    """Whether the cache is int8; it is only for the decoder-LM families,
    as in the reference."""
    quant = cfg.cache_quant == "int8"
    if quant and cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            "int8 KV cache is implemented for decoder-LM families")
    return quant


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def lm_prefill(params, cfg: ArchConfig, dims: ModelDims, tokens,
               cache: Dict[str, Any], *, patch_embeds=None
               ) -> Tuple[torch.Tensor, Dict[str, Any], Dict]:
    """Fill the cache from a full prompt; returns last-position logits."""
    require_ported(cfg)
    quant = _int8_cache(cfg)
    plus_one = cfg.name.startswith("gemma")
    b, s = tokens.shape
    positions = positions_for(tokens)
    x = embed_tokens(params, cfg, dims, tokens, patch_embeds)
    if cfg.family == "ssm":
        x, aux = _ssm_prefill(params, cfg, x, cache)
    elif cfg.family == "hybrid":
        x, aux = _hybrid_prefill(params, cfg, dims, x, positions, cache)
    else:
        x, aux, (ks, vs) = decoder_stack(params, cfg, dims, x, positions,
                                         collect_kv=True, plus_one=plus_one)
        with L.scope("nugget_block_attn.cache_write"):
            for i in range(cfg.n_layers):          # in place, layer by layer
                if quant:
                    for key, kv in (("k", ks[i]), ("v", vs[i])):
                        q, scale = KC.quantize_kv(kv)
                        cache[key][i, :, :s].copy_(q)
                        cache[f"{key}_scale"][i, :, :s].copy_(scale)
                else:
                    cache["k"][i, :, :s].copy_(ks[i])
                    cache["v"][i, :, :s].copy_(vs[i])
    cache["length"].fill_(s)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, plus_one=plus_one)
    logits = unembed(params, cfg, dims, x[:, -1:])
    return logits, cache, aux


def _ssm_prefill_layer(params, cfg, i, x, cache):
    """One Mamba2 layer over the prompt; its final SSM state and conv
    window go into layer ``i`` of the cache, in place."""
    p = layer_params(params, cfg, i)
    h = L.rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
    dtype = h.dtype
    z, xh, Bp, Cp, dt, conv_st = S._project(p["ssm"], cfg, h, dtype)
    y, h_fin = S.ssd(cfg.ssm_impl, xh, dt, S.a_of(p["ssm"]), Bp, Cp,
                     cfg.ssm.chunk)
    cache["ssm"][i].copy_(h_fin)
    cache["conv"][i].copy_(_merge_conv(conv_st))
    return x + S._finish(p["ssm"], cfg, y, xh, dt, z, dtype)


def _ssm_prefill(params, cfg, x, cache):
    for i in range(cfg.n_layers):
        x = _ssm_prefill_layer(params, cfg, i, x, cache)
    return x, {}


def _hybrid_prefill(params, cfg, dims, x, positions, cache):
    ae, n_groups, _ = _hybrid_groups(cfg)
    s = x.shape[1]
    rope = rope_tables(cfg, positions)
    for g in range(n_groups):
        for i in range(g * ae, (g + 1) * ae):
            x = _ssm_prefill_layer(params, cfg, i, x, cache)
        x, (k, v) = _shared_attn_block(params, cfg, dims, x, positions,
                                       collect_kv=True, rope=rope)
        cache["k"][g, :, :s].copy_(k)
        cache["v"][g, :, :s].copy_(v)
    for i in range(n_groups * ae, cfg.n_layers):
        x = _ssm_prefill_layer(params, cfg, i, x, cache)
    return x, {}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def lm_decode(params, cfg: ArchConfig, dims: ModelDims, token,
              cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any], Dict]:
    """One decode step.  token: [B,1] int.  Returns (logits, cache, aux);
    the cache is the one passed in, updated in place."""
    require_ported(cfg)
    quant = _int8_cache(cfg)
    plus_one = cfg.name.startswith("gemma")
    lengths = cache["length"]                        # [B] int32
    positions = lengths[:, None]
    x = embed_tokens(params, cfg, dims, token)
    aux = _aux_zero(cfg, x.device)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_layer(params, cfg, i, x, cache)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, dims, x, positions, cache)
    else:
        x = _dense_decode(params, cfg, dims, x, positions, cache, aux,
                          plus_one=plus_one, quant=quant)
    lengths.add_(1)            # every row, active or not, as the reference
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, plus_one=plus_one)
    logits = unembed(params, cfg, dims, x)
    return logits, cache, aux


def _dense_decode(params, cfg, dims, x, positions, cache, aux, *, plus_one,
                  quant=False):
    lengths = cache["length"]
    attend_len = lengths + 1                         # includes this token
    windows = cfg.layer_windows()
    rope = rope_tables(cfg, positions)               # once for all layers
    index = _write_index(lengths, cache["k"][0])
    for i in range(cfg.n_layers):
        p = layer_params(params, cfg, i)
        dt = x.dtype
        with L.scope("nugget_block_attn"):
            with L.scope("nugget_block_attn.qkv"):
                h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps,
                              plus_one=plus_one)
                q, k, v = A.qkv(p["attn"], cfg.attn, dims.layout, h,
                                positions, dt, rope_tables=rope)
            with L.scope("nugget_block_attn.cache_write"):
                if quant:
                    k_l, v_l, ks_l, vs_l = _write_kv_quant(
                        cache["k"][i], cache["v"][i], cache["k_scale"][i],
                        cache["v_scale"][i], k, v, lengths, index)
                else:
                    k_l, v_l = _write_kv(cache["k"][i], cache["v"][i], k, v,
                                         lengths, index)
            with L.scope("nugget_block_attn.attend"):
                if quant:                            # dequantized outside K2
                    k_l = KC.dequantize_kv(k_l, ks_l, dt)
                    v_l = KC.dequantize_kv(v_l, vs_l, dt)
                ctx = A.attend_decode(q, k_l, v_l, attend_len, dims.layout,
                                      window=windows[i], cap=cfg.attn.softcap,
                                      impl=cfg.attention_impl)
            with L.scope("nugget_block_attn.out"):
                attn_out = A.out_proj(p["attn"], dims.layout, ctx, dt)
        if cfg.parallel_block:
            h2 = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps, plus_one=plus_one)
            x = x + (attn_out + _ffn(p, cfg, h2, aux=aux))
        else:
            x = x + attn_out
            x = _mlp_block(p, cfg, x, plus_one=plus_one, aux=aux)
    return x


def _ssm_decode_layer(params, cfg, i, x, cache):
    """One Mamba2 layer for one token: layer ``i``'s SSM state is updated
    where it lies in the cache, its conv window copied back in place."""
    p = layer_params(params, cfg, i)
    h = L.rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
    conv_l = cache["conv"][i]
    out, _, conv_new = S.mamba2_decode(p["ssm"], cfg, h, cache["ssm"][i],
                                       _split_conv(cfg, conv_l))
    conv_l.copy_(_merge_conv(conv_new))
    return x + out


def _hybrid_decode(params, cfg, dims, x, positions, cache):
    ae, n_groups, _ = _hybrid_groups(cfg)
    lengths = cache["length"]
    attend_len = lengths + 1                         # includes this token
    rope = rope_tables(cfg, positions)
    index = _write_index(lengths, cache["k"][0])
    for g in range(n_groups):
        for i in range(g * ae, (g + 1) * ae):
            x = _ssm_decode_layer(params, cfg, i, x, cache)
        p_sh = params["shared_attn"]
        hh = L.rmsnorm(p_sh["norm"], x, cfg.norm_eps)
        q, k, v = A.qkv(p_sh["attn"], cfg.attn, dims.layout, hh, positions,
                        x.dtype, rope_tables=rope)
        k_l, v_l = _write_kv(cache["k"][g], cache["v"][g], k, v, lengths,
                             index)
        ctx = A.attend_decode(q, k_l, v_l, attend_len, dims.layout,
                              window=-1, impl=cfg.attention_impl)
        x = x + A.out_proj(p_sh["attn"], dims.layout, ctx, x.dtype)
        hh = L.rmsnorm(p_sh["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(p_sh["mlp"], hh, cfg.act, x.dtype)
    for i in range(n_groups * ae, cfg.n_layers):
        x = _ssm_decode_layer(params, cfg, i, x, cache)
    return x
