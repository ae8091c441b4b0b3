# Counterpart of src/repro/kernels/flash_attention.py (`flash_attention`,
# body `_flash_kernel`).  Forward only, as there: the JAX package trains with
# `attention_impl="chunked"`, and so does the port, so no backward is needed.
"""Flash attention forward (GQA, causal, sliding window, soft-cap): CUDA
kernels written by hand for Hopper, their plain PyTorch version, the launch
plan, and the wrapper that chooses between kernel and plain version by where
the tensor lies.

The kernels replace the Pallas TPU kernel ``_flash_kernel``.  bf16 inputs go
to ``csrc/flash_attention_tc.cu``: FlashAttention-2's layout on the tensor
cores (``mma.sync`` m16n8k16, bf16 in, f32 accumulators), Q in registers, K/V
through a three-stage ``cp.async`` ring with one block barrier a round, P kept
in registers as the A operand of the second product.  At the serving paths'
prefills (S 256-512) the work is a fraction of a GFLOP, so what bounds the
kernel is latency: the chain of kv tiles that one warp walks for its 16 q
rows.  A block of 8 warps therefore splits its q tile's kv range over
``kv_warps`` warps and merges their results once; ``attention_plan`` trades
row warps for kv warps so that the grid still fills the 132 SMs (zamba2's
prefill and long ones keep 128 q rows a block, one kv warp, and so read each
K/V tile from L2 once per 128 rows).  f32 inputs go to ``csrc/flash_attention.cu``, both
products in IEEE f32 on the CUDA cores (no TF32: the f32 checks of the
serving paths hold the kernels to 1e-4 of the largest logit).  Both keep the
scores out of device memory, skip the kv tiles that the causal frontier and
the window mask out, and mask the ragged edge in the kernel instead of
padding the inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
# (q and k width, v width) pairs that K1 takes in bf16 with v narrower than
# the keys: latent attention's expanded prefill (128 + 64 rope, v 128)
NARROW_V = ((192, 128),)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Window = Union[int, torch.Tensor, None]

N_SMS = 132                  # streaming multiprocessors of one H100 SXM
SMEM_LIMIT = 232_448         # shared memory one block may opt in to (227 KB)
# K1 takes the largest q tile whose grid leaves at most a tenth of the SMs
# without a block (zamba2-1.2b's prefill: 128 blocks of 128 rows measured
# faster than 256 of 64, PERF.md, PR 13)
TARGET_BLOCKS = N_SMS - N_SMS // 10


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How the kernel tiles one call: one block of ``warps`` warps per (q
    tile of ``bq`` rows, q head, row); each kv tile holds ``bk`` keys, and
    ``kv_warps`` warps share the q tile's kv tiles, one tile each a round."""
    bq: int
    bk: int
    warps: int
    kv_warps: int
    grid: Tuple[int, int, int]
    smem_bytes: int
    target_blocks: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def q_tiles(self, s: int) -> List[Tuple[int, int]]:
        """[q0, q1) of each block along S."""
        return [(i * self.bq, min(s, (i + 1) * self.bq))
                for i in range(self.grid[0])]

    def key_tiles(self, s: int, q0: int, causal: bool,
                  window: int) -> List[Tuple[int, int]]:
        """The kv tiles [k0, k1) the block of q tile ``q0`` walks, as the
        kernels do: from the window's lower edge to the causal frontier (all
        of [0, S) where ``window == 0`` masks every key).  Tile i goes to kv
        warp i % kv_warps."""
        lo, hi = 0, s
        if window != 0:
            if causal:
                hi = min(s, q0 + self.bq)
            if window > 0:
                lo = max(0, q0 - window + 1)
        return [(t * self.bk, min(s, (t + 1) * self.bk))
                for t in range(lo // self.bk, -(-hi // self.bk))]


def attention_plan(b: int, s: int, h: int, hd: int,
                   dtype: torch.dtype, dv: Optional[int] = None
                   ) -> AttentionPlan:
    """The tiles of one launch.  f32: 64 x 64 tiles of 256 threads (32 x 32 at
    head_dim 256), shared memory for Q, K, V and P as f32.  bf16: blocks of 8
    warps, the largest number of row warps (8, 4, 2: q tiles of 128, 64, 32
    rows) whose grid has TARGET_BLOCKS blocks, or 2 where none has; the rest
    of the 8 are kv warps.  kv tiles of 64 keys with one kv warp or at
    head_dim 64 and below, else 32 (half that at head_dim 256).  Shared
    memory: Q and three stages of a round (a K and a V tile for each kv
    warp), bf16, rows padded by 8 elements; after the loop the same memory
    holds every warp's f32 O, m and l for the merge."""
    if dtype != torch.float32:
        for rows in (8, 4, 2):
            if -(-s // (16 * rows)) * h * b >= TARGET_BLOCKS:
                break
        return bf16_plan(b, s, h, hd, rows, dv)
    bq = bk = 32 if hd == 256 else 64
    smem = 4 * (bq * (hd + 4) + bk * (hd + 4) + bk * hd + bq * (bk + 4))
    return AttentionPlan(bq=bq, bk=bk, warps=8, kv_warps=1,
                         grid=(-(-s // bq), h, b), smem_bytes=smem,
                         target_blocks=TARGET_BLOCKS)


def bf16_plan(b: int, s: int, h: int, hd: int, rows: int,
              dv: Optional[int] = None) -> AttentionPlan:
    """The bf16 tiles with ``rows`` row warps (8, 4 or 2) of the block's 8;
    ``attention_plan`` picks ``rows``, ``chip_smoke.py --phases plans`` times
    every choice.  ``dv``: the values' width where it is not ``hd``.  The kv
    tile is halved from 64 (one kv warp, or hd 64 and below) or 32 until
    three stages of a round fit the shared memory, as the kernel's
    ``tile_keys``."""
    dv = hd if dv is None else dv
    warps = 8
    kv_warps = warps // rows
    bq = 16 * rows
    bk = 64 if kv_warps == 1 or hd <= 64 else 32
    while bk > 16 and 2 * (hd + 8) * (bq + 3 * kv_warps * 2 * bk) > SMEM_LIMIT:
        bk //= 2
    smem = max(2 * (hd + 8) * (bq + 3 * kv_warps * 2 * bk),
               4 * warps * 16 * (dv + 6))
    return AttentionPlan(bq=bq, bk=bk, warps=warps, kv_warps=kv_warps,
                         grid=(-(-s // bq), h, b), smem_bytes=smem,
                         target_blocks=TARGET_BLOCKS)


def window_ok(dist: torch.Tensor, window: Window) -> Optional[torch.Tensor]:
    """Mask ``dist < window`` for a runtime window; ``None`` = no limit.
    ``window`` is an int or a 0-d integer tensor; < 0 means global."""
    if window is None:
        return None
    if isinstance(window, torch.Tensor):
        return (window < 0) | (dist < window)
    return None if window < 0 else dist < window


def gqa_scores(q: torch.Tensor, k: torch.Tensor, group: int) -> torch.Tensor:
    """q [B,Sq,KV*group,hd] . k [B,Sk,KV,hd] -> f32 [B,KV,group,Sq,Sk], with
    no repetition of k: the group's heads are folded into the row axis of one
    matrix product per kv head."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, group, hd).permute(0, 2, 3, 1, 4)
    s = torch.matmul(qg.reshape(b, kv, group * sq, hd),
                     k.float().permute(0, 2, 3, 1))
    return s.reshape(b, kv, group, sq, sk)


def gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,KV,group,Sq,Sk] . v [B,Sk,KV,hd] -> f32 [B,Sq,KV*group,hd]."""
    b, kv, group, sq, sk = p.shape
    o = torch.matmul(p.reshape(b, kv, group * sq, sk),
                     v.float().permute(0, 2, 1, 3))
    o = o.reshape(b, kv, group, sq, -1).permute(0, 3, 1, 2, 4)
    return o.reshape(b, sq, kv * group, -1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, group: int, causal: bool = True,
                          window: Window = None, cap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version.  q: [B,S,H,hd]; k: [B,Sk,KV,hd], v [B,Sk,KV,dv],
    H = KV*group; scores times ``scale`` (default hd^-1/2).  f32 inside, out
    in q's type; masked scores are the finite -1e30."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = gqa_scores(q, k, group) * (hd ** -0.5 if scale is None else scale)
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    dist = (torch.arange(sq, device=q.device)[:, None]
            - torch.arange(sk, device=q.device)[None, :])
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (dist >= 0)
    win = window_ok(dist, window)
    if win is not None:
        ok = ok & win
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return gqa_out(p, v).to(q.dtype)


def check_inputs(name: str, q: torch.Tensor, *others: torch.Tensor,
                 head_dims=HEAD_DIMS) -> None:
    """What the CUDA kernels take: one CUDA device, f32 or bf16 throughout,
    contiguous, 16-byte aligned, a head_dim the kernels are built for."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16 only)")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    for t in (q, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor is not 16-byte aligned")


def refuse_dtensor(name: str, *tensors: torch.Tensor) -> None:
    """A DTensor on the card passes the device check, but its
    ``data_ptr()`` is not the data of the global tensor that its shape
    describes: raise, by name, before anything reads it (no kernel of the
    port lies on a sharded path)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: the CUDA kernel takes plain tensors, not "
                        "DTensors; the sharded train step runs the chunked "
                        "attention and SSD")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernels write their outputs through raw pointers, so those have no
    ``grad_fn``: differentiating through a launch would give the inputs no
    gradient and raise nothing.  Raise instead, under grad mode, when any
    input requires grad (training takes the chunked paths)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; train with "
            "attention_impl=\"chunked\" and ssm_impl=\"chunked\" (the JAX "
            "package's training defaults)")


def window_arg(name: str, window: Window) -> int:
    """The kernels take the window as a launch argument, so on the card it
    is a host integer (a device tensor would cost a synchronisation)."""
    if window is None:
        return -1
    if isinstance(window, torch.Tensor):
        if window.device.type != "cpu":
            raise TypeError(f"{name}: pass `window` as an int, not as a "
                            "tensor on the device")
        return int(window)
    return int(window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int, causal: bool = True, window: Window = None,
                    cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k: [B,S,KV,hd], v: [B,S,KV,dv] with H = KV*group, dv
    = hd or a pair of `NARROW_V` in bf16; scores times ``scale`` (default
    hd^-1/2).  Positions are arange (rope applied by the caller).  A CUDA
    tensor goes to the kernel or raises; only a tensor that lies elsewhere
    (CPU, meta) takes the plain version."""
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, group=group, causal=causal,
                                     window=window, cap=cap, scale=scale)
    refuse_dtensor("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    b, s, h, hd = q.shape
    kv, dv = k.shape[2], v.shape[-1]
    narrow = dv != hd and (hd, dv) in NARROW_V and q.dtype == torch.bfloat16
    check_inputs("flash_attention", q, k, v,
                 head_dims=(hd,) if narrow else HEAD_DIMS)
    if (k.shape != (b, s, kv, hd) or v.shape != (b, s, kv, dv)
            or (dv != hd and not narrow) or h != kv * group):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"group {group}, dtype {q.dtype}")
    return launch_with_plan(q, k, v, attention_plan(b, s, h, hd, q.dtype, dv),
                            causal=causal,
                            window=window_arg("flash_attention", window),
                            cap=cap, scale=scale)


def launch_with_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     plan: AttentionPlan, *, causal: bool, window: int,
                     cap: float, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Launch the kernel with the tiles of ``plan`` on inputs that
    ``flash_attention`` has checked."""
    b, s, h, hd = q.shape
    dv = v.shape[-1]
    lib = build.load()
    out = q.new_empty((b, s, h, dv))
    with torch.cuda.device(q.device):
        err = lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], hd, dv, DTYPE_CODES[q.dtype], plan.bq,
            plan.kv_warps, plan.bk, int(bool(causal)), window, float(cap),
            1.0 / math.sqrt(hd) if scale is None else float(scale),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    build.count_launch("flash_attention")
    return out
