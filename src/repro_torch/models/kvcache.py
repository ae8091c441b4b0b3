# Counterpart of src/repro/models/kvcache.py.  Not ported yet: the int8 cache
# (`quantize_kv`, `dequantize_kv`, the scale arrays), the cross-attention
# cache of the enc-dec family, `update_layer_kv`, and the sharding helpers
# (`shard_cache`, `cache_specs`: one device here).
"""KV cache (decoder self-attention) + recurrent SSM state.

Layout: stacked over layers, ``k``/``v``: [L, B, S_max, KVp, hd]; SSM state
``ssm``: [L, B, nh, hp, N], f32 whatever the compute dtype; conv state
``conv``: [L, B, d_conv-1, conv_dim] in the compute dtype; ``length``: [B]
int32.  The cache is owned by its caller and **updated in place** by prefill
and decode, where the JAX package returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device


def init_cache(n_layers: int, batch: int, max_seq: int, kv_pad: int,
               head_dim: int, dtype, *, ssm: Optional[Dict[str, int]] = None,
               device: DeviceLike = None,
               quant: bool = False) -> Dict[str, Any]:
    if quant:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, Queue A: "
            "enc-dec, VLM, int8 weights and cache)")
    dev = resolve_device(device)
    cache: Dict[str, Any] = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if kv_pad:
        shape = (n_layers, batch, max_seq, kv_pad, head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if ssm is not None:
        cache["ssm"] = torch.zeros(
            (ssm["n_layers"], batch, ssm["n_heads"], ssm["head_dim"],
             ssm["d_state"]), dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (ssm["n_layers"], batch, ssm["d_conv"] - 1, ssm["conv_dim"]),
            dtype=dtype, device=dev)
    return cache
