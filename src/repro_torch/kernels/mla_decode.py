# No counterpart in src/repro: the JAX package has no latent attention.
"""Latent attention's decode step in the absorbed form: one query token a row
against the row's latent cache.  A CUDA kernel written by hand for Hopper
(``csrc/mla_decode.cu``), its plain PyTorch version, the split plan, and the
wrapper that chooses between them by where the tensor lies.

Each head's query has been absorbed into the latent (``q_nope W_UK``, 512
wide) and carries its roped part (64), so a head scores a cache row of 576
(the normalised latent and the roped key, shared by every head) and its
output is the latent's 512 weighted by the softmax; the caller un-absorbs it
(``W_UV``).  Every head reads the same keys: the kernel takes the 16 heads of
a row as one m16 tile of the tensor cores and reads each key once for them,
so it is bound by reading the cache.  The keys of a row are split over blocks
so that a batch fills the card (`split_plan`), and the last split of a row to
finish merges them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import refuse_dtensor, refuse_grad
from repro_torch.kernels.flash_decode import split_counters

LATENT, ROPE = 512, 64           # the widths the kernel is built for
HEAD_TILE = 16                   # heads a block: one m16 tile
KEY_TILE = 64                    # keys a tile of the kernel's loop
MAX_SPLITS = 64
# Blocks to aim for (one block of 175 KB of shared memory an SM at a time:
# about four waves of the 132 SMs), and no split shorter than this, so that
# a block's fixed cost (Q, its partial written and merged) is spread over at
# least four tiles.
TARGET_BLOCKS = 528
MIN_CHUNK = 256


def mla_decode_plain(q: torch.Tensor, cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     latent: int = LATENT) -> torch.Tensor:
    """Plain PyTorch version.  q: [B, H, latent + rope] (the absorbed query
    and its roped part); cache [B, S, latent + rope]; lengths [B]: keys in
    range, the current token included (rows with ``lengths > S`` see the
    whole cache) -> [B, H, latent] in q's type; f32 inside."""
    s = cache.shape[1]
    c = cache.float()
    sc = torch.einsum("bhd,bsd->bhs", q.float(), c) * scale
    ok = torch.arange(s, device=q.device)[None] < lengths.to(torch.int64)[:, None]
    sc = torch.where(ok[:, None], sc, -torch.inf)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhs,bsd->bhd", p, c[..., :latent]).to(q.dtype)


def split_plan(b: int, h: int, s: int):
    """(n_splits, chunk): the keys [0, S) cut over blocks, chunk a multiple
    of the kernel's tile.  Sized from the cache's capacity, not from the
    lengths, which stay on the device; a block whose chunk lies past its
    row's length reads nothing."""
    pairs = max(b * (h // HEAD_TILE), 1)
    want = 1
    while 2 * want * pairs <= TARGET_BLOCKS and 2 * want <= MAX_SPLITS:
        want *= 2
    chunk = max(MIN_CHUNK, -(-s // want))
    chunk = -(-chunk // KEY_TILE) * KEY_TILE
    return -(-s // chunk), chunk


def mla_decode(q: torch.Tensor, cache: torch.Tensor, lengths: torch.Tensor,
               *, scale: float, latent: int = LATENT) -> torch.Tensor:
    """A CUDA tensor goes to the kernel or raises; only a tensor that lies
    elsewhere (CPU, meta) takes the plain version."""
    if q.device.type != "cuda":
        return mla_decode_plain(q, cache, lengths, scale=scale, latent=latent)
    refuse_dtensor("mla_decode", q, cache)
    refuse_grad("mla_decode", q, cache)
    b, h, d = q.shape
    s = cache.shape[1]
    # bf16, heads in tiles of 16, a cache row of the latent's 512 and the
    # roped 64
    if (q.dtype != torch.bfloat16 or cache.dtype != q.dtype or h % HEAD_TILE
            or latent != LATENT or d != LATENT + ROPE
            or cache.shape != (b, s, d)):
        raise ValueError(f"mla_decode: q {tuple(q.shape)} {q.dtype}, cache "
                         f"{tuple(cache.shape)} {cache.dtype} (bf16, heads "
                         f"in tiles of {HEAD_TILE}, rows of "
                         f"{LATENT} + {ROPE})")
    for t in (q, cache):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mla_decode: inputs must be contiguous and "
                             "16-byte aligned")
    if (lengths.dtype != torch.int32 or lengths.shape != (b,)
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("mla_decode: lengths must be a contiguous int32 "
                         f"[{b}] tensor on {q.device}")
    n_splits, chunk = split_plan(b, h, s)
    return launch_with_split(q, cache, lengths, scale=scale,
                             n_splits=n_splits, chunk=chunk)


def launch_with_split(q: torch.Tensor, cache: torch.Tensor,
                      lengths: torch.Tensor, *, scale: float, n_splits: int,
                      chunk: int) -> torch.Tensor:
    """Launch the kernel with the keys cut into ``n_splits`` chunks of
    ``chunk``, on inputs that ``mla_decode`` has checked."""
    b, h, _ = q.shape
    lib = build.load()
    out = q.new_empty((b, h, LATENT))
    part_m = part_l = part_acc = counters = None
    if n_splits > 1:
        n = b * h * n_splits
        part = torch.empty((n * (LATENT + 2),), dtype=torch.float32,
                           device=q.device)
        part_acc = part.data_ptr()
        part_m = part_acc + 4 * n * LATENT
        part_l = part_m + 4 * n
        counters = split_counters(q.device, b * h // HEAD_TILE).data_ptr()
    with torch.cuda.device(q.device):
        err = lib.rt_mla_decode(
            q.data_ptr(), cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_m, part_l, part_acc, b, cache.shape[1], h,
            n_splits, chunk, counters, float(scale),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "mla_decode")
    build.count_launch("mla_decode")
    return out
