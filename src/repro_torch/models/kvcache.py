# Counterpart of src/repro/models/kvcache.py; nothing of it is left
# unported.  `shard_cache` and the `shard(...)` of `update_layer_kv` are
# identities unless a plan is active and the tensors are DTensors.
"""KV cache (decoder self-attention) + recurrent SSM state.

Layout: stacked over layers, ``k``/``v``: [L, B, S_max, KVp, hd]; SSM state
``ssm``: [L, B, nh, hp, N], f32 whatever the compute dtype; conv state
``conv``: [L, B, d_conv-1, conv_dim] in the compute dtype; ``length``: [B]
int32.  With ``quant`` the k/v payload is int8 and ``k_scale``/``v_scale``
([L, B, S_max, KVp], bf16) hold one scale per (token, head).  The enc-dec
family's cross-attention cache ``cross_k``/``cross_v`` ([L, B, cross_len,
KVp, hd], compute dtype) holds the encoder's projected k/v.  Latent
attention (the port's own) caches ``latent``: [L, B, S_max, r + dr] in the
compute dtype, the normalised latent and the roped key of each token.  The
cache is
owned by its caller and **updated in place** by prefill and decode, where
the JAX package returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import shard

CACHE_AXES = {
    "k": (None, "batch", "kv_seq", "act_heads", None),
    "v": (None, "batch", "kv_seq", "act_heads", None),
    "k_scale": (None, "batch", "kv_seq", "act_heads"),
    "v_scale": (None, "batch", "kv_seq", "act_heads"),
    "cross_k": (None, "batch", None, "act_heads", None),
    "cross_v": (None, "batch", None, "act_heads", None),
    "ssm": (None, "batch", "act_heads", None, None),
    "conv": (None, "batch", None, "ssm_inner"),
    "length": ("batch",),
}
# the port's own leaves: latent attention's cache
PORT_CACHE_AXES = {"latent": (None, "batch", "kv_seq", None)}
_AXES = {**CACHE_AXES, **PORT_CACHE_AXES}


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) int8 quantization.  x: [..., hd] ->
    (int8 [..., hd], scale [...] bf16 with the /127 folded in)."""
    xf = x.float()
    scale = torch.clamp(torch.amax(xf.abs(), dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def init_cache(n_layers: int, batch: int, max_seq: int, kv_pad: int,
               head_dim: int, dtype, *, ssm: Optional[Dict[str, int]] = None,
               cross_len: int = 0, device: DeviceLike = None,
               quant: bool = False, latent_dim: int = 0) -> Dict[str, Any]:
    dev = resolve_device(device)
    cache: Dict[str, Any] = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if kv_pad:
        shape = (n_layers, batch, max_seq, kv_pad, head_dim)
        kv_dtype = torch.int8 if quant else dtype
        cache["k"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
        if quant:
            cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                           device=dev)
            cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                           device=dev)
    if latent_dim:
        cache["latent"] = torch.zeros((n_layers, batch, max_seq, latent_dim),
                                      dtype=dtype, device=dev)
    if cross_len and kv_pad:
        shape = (n_layers, batch, cross_len, kv_pad, head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if ssm is not None:
        cache["ssm"] = torch.zeros(
            (ssm["n_layers"], batch, ssm["n_heads"], ssm["head_dim"],
             ssm["d_state"]), dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (ssm["n_layers"], batch, ssm["d_conv"] - 1, ssm["conv_dim"]),
            dtype=dtype, device=dev)
    return cache


def shard_cache(cache: Dict[str, Any]) -> Dict[str, Any]:
    return {k: shard(v, *_AXES[k]) for k, v in cache.items()}


def cache_specs(cache: Dict[str, Any], plan) -> Dict[str, Any]:
    return {k: plan.spec(_AXES[k]) for k in cache}


def update_layer_kv(k_layer: torch.Tensor, v_layer: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, index: int):
    """Write k_new/v_new ([B,s,KVp,hd]) at position ``index``, in place.
    As the reference's ``dynamic_update_slice``, the start is clamped so
    that the ``s`` positions fit in the cache."""
    s = k_new.shape[1]
    i = max(0, min(int(index), k_layer.shape[1] - s))
    k_layer[:, i:i + s].copy_(k_new)
    v_layer[:, i:i + s].copy_(v_new)
    return (shard(k_layer, "batch", "kv_seq", "act_heads", None),
            shard(v_layer, "batch", "kv_seq", "act_heads", None))
