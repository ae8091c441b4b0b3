# Counterpart of src/repro/kernels/flash_decode.py (`flash_decode`, body
# `_decode_kernel`).  The int8 cache (dequantisation fused into the load)
# is not ported yet.
"""Flash decode: one query token per row against a KV cache with per-row
lengths.  A CUDA kernel written by hand for Hopper, its plain PyTorch
version, and the wrapper that chooses between them by where the tensor lies.

The kernel (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``_decode_kernel``.  On this card the function is bound by bytes: each cache
entry in range is read once and used for two flops per byte.  The design
reads each K/V tile once for all ``group`` q heads that share the kv head,
stops at ``min(lengths[b], S)`` and starts at the window's lower edge, loads
16 bytes a thread along ``hd``, and splits the kv range over several blocks
(partials combined by a second small kernel) so that a small batch still
fills the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES, NEG_INF, Window, check_inputs, gqa_out, gqa_scores,
    window_arg, window_ok)

# blocks to aim for when the kv range is split (a few per multiprocessor)
TARGET_BLOCKS = 528


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor, *,
                       group: int, window: Window = None,
                       cap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version.  q: [B,1,H,hd]; caches [B,S,KV,hd]; lengths
    [B] = valid entries including the current token (query position
    ``lengths - 1``; rows with ``lengths > S`` see the whole cache)."""
    hd, s = q.shape[-1], k_cache.shape[1]
    sc = gqa_scores(q, k_cache, group) / math.sqrt(hd)
    if cap > 0:
        sc = cap * torch.tanh(sc / cap)
    cur = (lengths.to(torch.int64) - 1)[:, None]
    dist = cur - torch.arange(s, device=q.device)[None, :]        # [B,S]
    ok = dist >= 0
    win = window_ok(dist, window)
    if win is not None:
        ok = ok & win
    sc = torch.where(ok[:, None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return gqa_out(p, v_cache).to(q.dtype)


def split_plan(b: int, kv: int, s: int, tile: int):
    """(n_splits, chunk): how the kv range [0, S) is cut over blocks.  Sized
    from the cache's capacity, not from the lengths, which stay on the
    device; a block whose chunk lies beyond its row's length returns at once."""
    n_tiles = -(-s // tile)
    want = max(1, min(n_tiles, TARGET_BLOCKS // max(b * kv, 1)))
    chunk = -(-n_tiles // want) * tile
    return -(-s // chunk), chunk


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *, group: int,
                 window: Window = None, cap: float = 0.0) -> torch.Tensor:
    """A CUDA tensor goes to the kernel or raises; only a tensor that lies
    elsewhere (CPU, meta) takes the plain version."""
    if q.device.type != "cuda":
        return flash_decode_plain(q, k_cache, v_cache, lengths, group=group,
                                  window=window, cap=cap)
    check_inputs("flash_decode", q, k_cache, v_cache)
    b, one, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if (one != 1 or k_cache.shape != (b, s, kv, hd)
            or v_cache.shape != k_cache.shape or h != kv * group):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"group {group}")
    if (lengths.dtype != torch.int32 or lengths.shape != (b,)
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("flash_decode: lengths must be a contiguous int32 "
                         f"[{b}] tensor on {q.device}")
    win = window_arg("flash_decode", window)
    lib = build.load()
    n_splits, chunk = split_plan(b, kv, s, lib.rt_flash_decode_tile())
    out = torch.empty_like(q)
    if n_splits > 1:
        part = torch.empty((b * h * n_splits, hd + 2), dtype=torch.float32,
                           device=q.device)
        n = b * h * n_splits
        part_m = part.data_ptr()
        part_l = part_m + 4 * n
        part_acc = part_l + 4 * n
    else:
        part_m = part_l = part_acc = None
    with torch.cuda.device(q.device):
        err = lib.rt_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_m, part_l, part_acc,
            b, s, h, kv, hd, DTYPE_CODES[q.dtype], n_splits, chunk, win,
            float(cap), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0         # kernel launches made by the wrapper
