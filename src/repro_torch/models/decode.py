# Counterpart of src/repro/models/decode.py, dense family only.  Not ported
# yet: the int8 cache (`_write_kv_quant`), the SSM and hybrid prefill and
# decode (`_ssm_prefill`, `_hybrid_prefill`, the conv-state helpers).
"""Prefill and single-token decode over the stacked KV cache.

The cache is **updated in place** (the JAX package returns new arrays): the
prefill copies each layer's k/v into the cache's first ``s`` positions, the
decode step writes one token per row at that row's length.  Both return the
same cache object for the reference's call shape ``logits, cache, aux``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (
    ModelDims, _mlp_block, decoder_stack, embed_tokens, layer_params,
    positions_for, require_ported, rope_tables, unembed,
)


def _write_index(lengths: torch.Tensor, capacity: int):
    """(rows, pos, ok) of a step's per-row cache write, made once per step.

    A row whose length is at or beyond the cache's capacity (a finished or
    never-used slot keeps counting) must write nothing: the reference's
    scatter drops out-of-range indices, while an out-of-range index on CUDA
    is a device-side assert.  So the position is clamped and ``ok`` marks
    the rows that really write; no host synchronisation."""
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    pos = lengths.to(torch.int64)
    ok = ((pos >= 0) & (pos < capacity))[:, None, None]
    return rows, pos.clamp(0, capacity - 1), ok


def _write_kv(k_l, v_l, k_new, v_new, lengths, index=None):
    """Per-row write of one token's kv at each row's length, in place.
    Rows out of range keep their old value (see `_write_index`)."""
    rows, pos, ok = (_write_index(lengths, k_l.shape[1]) if index is None
                     else index)
    k_l[rows, pos] = torch.where(ok, k_new[:, 0].to(k_l.dtype), k_l[rows, pos])
    v_l[rows, pos] = torch.where(ok, v_new[:, 0].to(v_l.dtype), v_l[rows, pos])
    return k_l, v_l


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def lm_prefill(params, cfg: ArchConfig, dims: ModelDims, tokens,
               cache: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, Any], Dict]:
    """Fill the cache from a full prompt; returns last-position logits."""
    require_ported(cfg)
    plus_one = cfg.name.startswith("gemma")
    b, s = tokens.shape
    positions = positions_for(tokens)
    x = embed_tokens(params, cfg, dims, tokens)
    x, aux, (ks, vs) = decoder_stack(params, cfg, dims, x, positions,
                                     collect_kv=True, plus_one=plus_one)
    for i in range(cfg.n_layers):                  # in place, layer by layer
        cache["k"][i, :, :s].copy_(ks[i])
        cache["v"][i, :, :s].copy_(vs[i])
    cache["length"].fill_(s)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, plus_one=plus_one)
    logits = unembed(params, cfg, dims, x[:, -1:])
    return logits, cache, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def lm_decode(params, cfg: ArchConfig, dims: ModelDims, token,
              cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any], Dict]:
    """One decode step.  token: [B,1] int.  Returns (logits, cache, aux);
    the cache is the one passed in, updated in place."""
    require_ported(cfg)
    plus_one = cfg.name.startswith("gemma")
    lengths = cache["length"]                        # [B] int32
    positions = lengths[:, None]
    attend_len = lengths + 1                         # includes this token
    x = embed_tokens(params, cfg, dims, token)
    windows = cfg.layer_windows()
    aux: Dict = {}
    rope = rope_tables(cfg, positions)               # once for all layers
    index = _write_index(lengths, cache["k"].shape[2])

    for i in range(cfg.n_layers):
        p = layer_params(params, cfg, i)
        h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps, plus_one=plus_one)
        dt = x.dtype
        q, k, v = A.qkv(p["attn"], cfg.attn, dims.layout, h, positions, dt,
                        rope_tables=rope)
        k_l, v_l = _write_kv(cache["k"][i], cache["v"][i], k, v, lengths,
                             index)
        ctx = A.attend_decode(q, k_l, v_l, attend_len, dims.layout,
                              window=windows[i], cap=cfg.attn.softcap,
                              impl=cfg.attention_impl)
        attn_out = A.out_proj(p["attn"], dims.layout, ctx, dt)
        if cfg.parallel_block:
            h2 = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps, plus_one=plus_one)
            x = x + (attn_out + L.mlp(p["mlp"], h2, cfg.act, dt))
        else:
            x = x + attn_out
            x = _mlp_block(p, cfg, x, plus_one=plus_one, aux=aux)

    lengths.add_(1)            # every row, active or not, as the reference
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, plus_one=plus_one)
    logits = unembed(params, cfg, dims, x)
    return logits, cache, aux
