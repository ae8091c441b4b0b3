# Counterpart of src/repro/kernels/flash_decode.py (`flash_decode`, body
# `_decode_kernel`).  An int8 cache is dequantized outside the kernel, as in
# the reference (models/decode.py); fusing the dequantization into the load
# is optional performance work.
"""Flash decode: one query token per row against a KV cache with per-row
lengths.  A CUDA kernel written by hand for Hopper, its plain PyTorch
version, the split plan, and the wrapper that chooses between kernel and
plain version by where the tensor lies.

The kernel (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``_decode_kernel``.  On this card the function is bound by bytes: each cache
entry in range is read once and used for two flops per byte, so the CUDA
cores suffice and what matters is keeping loads in flight.  A block of 4
warps reads each K/V row once for up to 8 q heads of its kv head, walks
only from the window's lower edge to ``min(lengths[b], S)``, and each warp
keeps 4 steps of K and V in flight in its own ``cp.async`` ring of 8, read
back by the lanes that copied them, so the key loop has no barrier; scores
are partial dot products plus shuffles across the lanes of a key, 4 steps at
a time.  The kv range
is split over several blocks so that a small batch still fills the card; the
last block of a (row, head block) to finish merges the splits, found by an
atomic counter that it resets to 0 (``split_counters``, allocated once per
device).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES, NEG_INF, Window, check_inputs, gqa_out, gqa_scores,
    refuse_dtensor, refuse_grad, window_arg, window_ok)

# Blocks to aim for when the kv range is split: about four per SM.  Each
# (row, kv head) takes the largest power of two of splits that keeps the grid
# within this: 8 at qwen3-1.7b's decode, the fastest there, and 2 at
# zamba2-1.2b's, where 1 is a little faster (`chip_smoke.py --phases plans`,
# PERF.md, PR 13).
TARGET_BLOCKS = 512
# ... and no split shorter than this, so that a block's fixed cost (q in
# registers, the merge of its warps, a partial written and read back) is
# spread over at least 32 keys a warp.
MIN_CHUNK = 128
# The kernel's layout (csrc/flash_decode.cu): warps a block, warp steps in
# flight per warp, q heads a block keeps in registers.
WARPS, STAGES, MAX_HEADS = 4, 8, 8


def head_blocks(group: int):
    """(n_blocks, heads_per_block): a group of more than MAX_HEADS q heads is
    cut into even head blocks, each reading the kv head's cache once."""
    n = -(-group // MAX_HEADS)
    return n, -(-group // n)


_counters: dict = {}      # device -> int32 split counters, all 0 between launches
_outgrown: list = []      # counters that a larger set replaced, never freed


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, kept from launch to launch:
    the kernel's last split of each (row, head block) resets its counter, so
    they are 0 again after every launch.  Grown (never shrunk) on demand.
    Launches on one stream, as the port makes them, never share them at
    once.  A CUDA graph keeps the address its capture saw, so a set that a
    larger one replaces is kept alive (and stays 0) for the graphs that
    hold it."""
    t = _counters.get(device)
    if t is None or t.numel() < n:
        if t is not None:
            _outgrown.append(t)
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = t
    return t


def decode_layout(hd: int, dtype: torch.dtype) -> dict:
    """How the kernel lays a key row over a warp, and the shared memory a
    block asks for: its warps' rings of K and V, reused after the key loop
    for the warps' (acc, m, l) of up to MAX_HEADS heads."""
    segs = hd * (4 if dtype == torch.float32 else 2) // 16   # 16-byte pieces
    lanes = min(32, segs)
    ring = WARPS * STAGES * 2 * (segs // lanes) * 32 * 16
    merge = WARPS * MAX_HEADS * (hd + 2) * 4
    return {"lanes_per_key": lanes, "keys_per_step": 32 // lanes,
            "segments_per_lane": segs // lanes,
            "smem_bytes": max(ring, merge)}


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
    """(n_splits, chunk): how the kv range [0, S) is cut over blocks, chunk a
    multiple of ``tile``.  Sized from the cache's capacity, not from the
    lengths, which stay on the device; a block whose chunk lies beyond its
    row's length skips the key loop."""
    pairs = max(b * kv, 1)
    want = 1
    while 2 * want * pairs <= TARGET_BLOCKS:
        want *= 2
    chunk = max(MIN_CHUNK, -(-s // want))
    chunk = min(-(-chunk // tile), -(-s // tile)) * tile
    return -(-s // chunk), chunk


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *, group: int,
                 window: Window = None, cap: float = 0.0) -> torch.Tensor:
    """A CUDA tensor goes to the kernel or raises; only a tensor that lies
    elsewhere (CPU, meta) takes the plain version."""
    if q.device.type != "cuda":
        return flash_decode_plain(q, k_cache, v_cache, lengths, group=group,
                                  window=window, cap=cap)
    refuse_dtensor("flash_decode", q, k_cache, v_cache)
    refuse_grad("flash_decode", q, k_cache, v_cache)
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
    n_splits, chunk = split_plan(b, kv, s, build.load().rt_flash_decode_tile())
    return launch_with_split(q, k_cache, v_cache, lengths, group=group,
                             window=win, cap=cap, n_splits=n_splits,
                             chunk=chunk)


def launch_with_split(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor, *,
                      group: int, window: int, cap: float, n_splits: int,
                      chunk: int) -> torch.Tensor:
    """Launch the kernel with the kv range cut into ``n_splits`` chunks of
    ``chunk`` keys, on inputs that ``flash_decode`` has checked;
    ``split_plan`` picks the cut, ``chip_smoke.py --phases plans`` times
    others."""
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    n_hb, hpb = head_blocks(group)
    lib = build.load()
    out = torch.empty_like(q)
    if n_splits > 1:
        part = torch.empty((b * h * n_splits, hd + 2), dtype=torch.float32,
                           device=q.device)
        n = b * h * n_splits
        part_m = part.data_ptr()
        part_l = part_m + 4 * n
        part_acc = part_l + 4 * n
        counters = split_counters(q.device, b * kv * n_hb).data_ptr()
    else:
        part_m = part_l = part_acc = counters = None
    with torch.cuda.device(q.device):
        err = lib.rt_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_m, part_l, part_acc,
            counters, b, s, h, kv, hd, DTYPE_CODES[q.dtype], hpb, n_splits,
            chunk, window, float(cap), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_decode")
    build.count_launch("flash_decode")
    return out
