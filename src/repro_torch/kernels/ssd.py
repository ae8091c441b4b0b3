# Counterpart of src/repro/kernels/ssd.py (`ssd_intra`, body `_ssd_kernel`,
# `pallas_call` at :82).  Forward only, as there (training takes
# `ssm_impl="chunked"`, in the JAX package and here).  `ssd_intra` returns the
# reference's four outputs; its `cum` is written by the kernel itself (the
# reference recomputes it outside), and `y` is not padded to whole chunks.
"""SSD (Mamba2) intra-chunk tile: CUDA kernels written by hand for Hopper,
their plain PyTorch version, the launch plan, and the wrapper that chooses
between kernel and plain version by where the tensor lies.

The kernels replace the Pallas TPU kernel ``_ssd_kernel`` of
``src/repro/kernels/ssd.py:62``.  Per (batch, head, chunk of q steps):
``cum = cumsum(dt·A)``; ``y_intra = (L ∘ (C Bᵀ)) (x·dt)`` with
``L[t,s] = exp(cum_t − cum_s)`` for t ≥ s, else 0; ``s_chunk =
(x·dt·exp(cum_last − cum))ᵀ B``; ``decay = exp(cum_last)``; and ``cum``
itself, which the inter-chunk term of ``ops.ssd`` needs.

bf16 inputs (what serving feeds it) go to ``csrc/ssd_tc.cu``: work items
finer than (batch, head, chunk) so that the grid fills the card (a 64-row t
tile of one chunk for a group of heads, or the s_chunk of one head), ``C Bᵀ``
computed once per head group, all three products by ``mma.sync`` on bf16
fragments with f32 sums, the f32 operand of the y and s_chunk products split
into two bf16 parts (``hi + lo``) so that the products keep f32 accuracy.
``ssd_plan`` chooses the head group and whether a block takes a long and a
short t tile together; ``SsdPlan.block`` says what each block does, as the
kernel decodes it.  f32 inputs (and bf16 inputs whose pointers the kernel's
16- and 8-byte copies cannot take) go to ``csrc/ssd.cu``: one block per
(batch, head, chunk), IEEE f32 on the CUDA cores.  Both keep every
intermediate out of device memory, mask the ragged last chunk in the kernel
instead of padding it, and never weight a step above the diagonal.

On this card the function is bound by bytes: it reads x, dt, B and C once
and writes y and s_chunk once (about 13 MB at mamba2-780m's prefill shape),
while its products are about 1.2 GFLOP when ``C Bᵀ`` is counted once per
(batch, chunk).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPE_CODES, N_SMS,
                                                 refuse_dtensor, refuse_grad)

HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128
T_TILE = 64                  # steps in a t tile and an s tile (both kernels)
TC_STAGES = 2                # the bf16 kernel's ring of s tiles
# the bf16 kernel keeps the y rows of every head of its group in registers:
# G * hp <= 128 (64 f32 a thread); the kernel is built for these G
TC_HEADS = {16: (1, 2, 4, 8), 32: (1, 2, 4), 64: (1, 2)}
# the bf16 plan takes the largest head group whose grid has a block for
# every SM (132 on one H100)
TARGET_BLOCKS = N_SMS
TC_BLOCKS_PER_SM = 2         # what its registers and shared memory allow
# it pairs a long and a short t tile in one block where the grid would
# otherwise take more than this many waves of TC_BLOCKS_PER_SM blocks an SM
# (on one H100, `chip_smoke.py --phases device,build,plans`: zamba2-1.2b's
# prefill, 1.45 waves, paired 0.0236 against 0.0262 ms; mamba2-780m's, 1.09
# waves, 0.0278 against 0.0224)
PAIR_WAVES = 1.25


def chunking(s: int, chunk: int) -> Tuple[int, int, int]:
    """(q, nc, pad): steps per chunk, chunks, zero steps after the last."""
    q = min(chunk, s)
    nc = -(-s // q)
    return q, nc, nc * q - s


def pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero steps after the last along axis 1 of [B,S,...]."""
    if not pad:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """How one launch cuts the work.  ``route`` "tc" (bf16, ``ssd_tc.cu``):
    grid (head groups of ``heads_per_block``, batch × chunks, y slots +
    ``heads_per_block``); a y slot is one t tile of 64 steps, or with
    ``pair`` a long and a short one; the other ``heads_per_block`` z indices
    are the s_chunk items of the group's heads, one head each.  ``route``
    "f32" (``ssd.cu``): grid (chunks, heads, batch), each block the whole
    chunk of one head."""
    route: str
    heads_per_block: int
    pair: bool
    grid: Tuple[int, int, int]
    smem_bytes: int
    target_blocks: int
    b: int
    s: int
    nh: int
    q: int
    nc: int

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def n_tt(self) -> int:
        return -(-self.q // T_TILE)

    def block(self, bx: int, by: int, bz: int) -> Optional[Dict[str, object]]:
        """What block (bx, by, bz) computes, as the kernel decodes it, or
        None for a block that returns at once: ``b``, ``c``, ``heads``, the
        ``t_tiles`` whose y rows it writes (each walking the s tiles 0..t),
        and whether it writes s_chunk, cum and decay (``states``)."""
        if self.route == "f32":
            c, h, b = bx, by, bz
            n_valid = min(self.q, self.s - c * self.q)
            return {"b": b, "c": c, "heads": [h], "states": True,
                    "t_tiles": [t for t in range(self.n_tt)
                                if t * T_TILE < n_valid]}
        g = self.heads_per_block
        b, c = divmod(by, self.nc)
        n_valid = min(self.q, self.s - c * self.q)
        if 1 <= bz <= g:                                  # s_chunk item
            h = bx * g + bz - 1
            if h >= self.nh:
                return None
            return {"b": b, "c": c, "heads": [h], "states": True,
                    "t_tiles": []}
        h0 = bx * g
        if h0 >= self.nh:
            return None
        slot = 0 if bz == 0 else bz - g
        first = self.n_tt - 1 - slot
        tiles = [first] + ([slot] if self.pair and slot < first else [])
        tiles = [t for t in tiles if t * T_TILE < n_valid]
        if not tiles:
            return None
        return {"b": b, "c": c, "heads": list(range(h0, min(h0 + g, self.nh))),
                "states": False, "t_tiles": tiles}

    def blocks_list(self) -> List[Dict[str, object]]:
        gx, gy, gz = self.grid
        out = [self.block(x, y, z) for z in range(gz) for y in range(gy)
               for x in range(gx)]
        return [b for b in out if b is not None]


def tc_smem_bytes(hp: int, g: int, q: int, n: int) -> int:
    """Shared memory of a bf16 block (``ssdtc::smem_bytes``): dt, cum and the
    off-diagonal y weights of the group's heads and the s_chunk weights
    (f32), the C tile, and TC_STAGES × (B tile, x tile of the group), bf16,
    rows padded by 8."""
    qp = -(-q // T_TILE) * T_TILE
    ldb = -(-n // 16) * 16 + 8
    ldx = g * hp + 8
    return (4 * (3 * g * qp + qp) + 2 * T_TILE * ldb
            + TC_STAGES * 2 * T_TILE * (ldb + ldx))


def ssd_plan(b: int, s: int, nh: int, hp: int, n: int, chunk: int,
             dtype: torch.dtype, *, heads_per_block: Optional[int] = None,
             pair: Optional[bool] = None) -> SsdPlan:
    """The launch of one call.  bf16: the largest head group (of
    ``TC_HEADS[hp]``) whose grid has ``TARGET_BLOCKS`` blocks, or 1 where
    none has; a long and a short t tile share a block where the unpaired
    grid would take more than ``PAIR_WAVES`` waves and the paired one still
    has ``TARGET_BLOCKS`` blocks.  f32: one block per (batch, head, chunk).
    ``heads_per_block`` and ``pair`` override the choice (``chip_smoke.py
    --phases plans`` times every one)."""
    q, nc, _ = chunking(s, chunk)
    n_tt = -(-q // T_TILE)
    if dtype == torch.float32:
        qp = n_tt * T_TILE
        smem = 4 * (3 * qp + 2 * T_TILE * (n + 4) + T_TILE * (hp + 4)
                    + T_TILE * (T_TILE + 4))
        return SsdPlan("f32", 1, False, (nc, nh, b), smem, TARGET_BLOCKS,
                       b, s, nh, q, nc)

    def grid(g, paired):
        slots = (n_tt + 1) // 2 if paired else n_tt
        return (-(-nh // g), b * nc, slots + g)

    if heads_per_block is None:
        heads_per_block = 1
        for g in sorted(TC_HEADS[hp], reverse=True):
            if math.prod(grid(g, False)) >= TARGET_BLOCKS:
                heads_per_block = g
                break
    if heads_per_block not in TC_HEADS[hp]:
        raise ValueError(f"ssd_plan: {heads_per_block} heads a block at "
                         f"head_dim {hp} (one of {TC_HEADS[hp]})")
    if pair is None:
        alone = math.prod(grid(heads_per_block, False))
        pair = (n_tt > 1 and alone > PAIR_WAVES * TC_BLOCKS_PER_SM * N_SMS
                and math.prod(grid(heads_per_block, True)) >= TARGET_BLOCKS)
    return SsdPlan("tc", heads_per_block, bool(pair),
                   grid(heads_per_block, pair),
                   tc_smem_bytes(hp, heads_per_block, q, n), TARGET_BLOCKS,
                   b, s, nh, q, nc)


def ssd_intra_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bp: torch.Tensor, Cp: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version.  xh [B,S,nh,hp]; dt [B,S,nh] f32; A [nh] f32;
    Bp/Cp [B,S,N].  Returns (y_intra [B,S,nh,hp], s_chunk [B,nc,nh,hp,N],
    decay [B,nc,nh], cum [B,nc,q,nh]), all f32.  The ragged last chunk is
    zero-padded, as in the reference."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nc, pad = chunking(s, chunk)
    xf = pad_steps(xh.float(), pad).reshape(b, nc, q, nh, hp)
    dtc = pad_steps(dt.float(), pad).reshape(b, nc, q, nh)
    Bc = pad_steps(Bp.float(), pad).reshape(b, nc, q, n)
    Cc = pad_steps(Cp.float(), pad).reshape(b, nc, q, n)

    cum = torch.cumsum(dtc * A, dim=2)                     # [b,c,q,nh]
    xdt = xf * dtc[..., None]                              # [b,c,q,nh,hp]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [b,c,t,s,nh]
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    # mask before exp: the upper triangle is never exponentiated
    Lk = torch.exp(torch.where(tri[:, :, None], rel, -torch.inf))
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))            # [b,c,t,s]
    w = (Lk * cb[..., None]).permute(0, 1, 4, 2, 3)        # [b,c,nh,t,s]
    y = torch.matmul(w, xdt.permute(0, 1, 3, 2, 4))        # [b,c,nh,t,hp]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * q, nh, hp)[:, :s]

    decay_out = torch.exp(cum[:, :, -1:, :] - cum)         # [b,c,q,nh]
    xw = (xdt * decay_out[..., None]).permute(0, 1, 3, 4, 2)   # [b,c,nh,hp,q]
    s_chunk = torch.matmul(xw, Bc[:, :, None])             # [b,c,nh,hp,N]
    return y, s_chunk, torch.exp(cum[:, :, -1]), cum


def _check(xh, dt, A, Bp, Cp) -> None:
    """What the CUDA kernel takes: one device; x, B, C f32 or bf16 alike;
    dt and A f32; contiguous; hp in HEAD_DIMS; N a multiple of 4 up to 128."""
    name = "ssd_intra"
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    if xh.dtype not in DTYPE_CODES or Bp.dtype != xh.dtype \
            or Cp.dtype != xh.dtype:
        raise TypeError(f"{name}: x, B, C dtypes {xh.dtype}, {Bp.dtype}, "
                        f"{Cp.dtype} (all float32 or all bfloat16)")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32")
    if (dt.shape != (b, s, nh) or A.shape != (nh,) or Bp.shape != (b, s, n)
            or Cp.shape != Bp.shape):
        raise ValueError(f"{name}: shapes x {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bp.shape)}, C {tuple(Cp.shape)}")
    if hp not in HEAD_DIMS or n % 4 or not 0 < n <= MAX_STATE or s == 0:
        raise ValueError(f"{name}: head_dim {hp} (one of {HEAD_DIMS}), "
                         f"d_state {n} (a multiple of 4 up to {MAX_STATE}), "
                         f"S {s}")
    for t in (xh, dt, A, Bp, Cp):
        if t.device != xh.device:
            raise ValueError(f"{name}: tensors on {t.device} and {xh.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")


def _tc_vec(xh, Bp, Cp) -> int:
    """Bytes a copy of B and C for the bf16 kernel (16, or 8 where N is no
    multiple of 8 or B, C lie off 16 bytes), 0 where it cannot take the
    pointers (x off 16 bytes, B or C off 8)."""
    if xh.data_ptr() % 16 or Bp.data_ptr() % 8 or Cp.data_ptr() % 8:
        return 0
    if Bp.shape[-1] % 8 == 0 and Bp.data_ptr() % 16 == 0 \
            and Cp.data_ptr() % 16 == 0:
        return 16
    return 8


def ssd_intra(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bp: torch.Tensor, Cp: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, ...]:
    """(y_intra, s_chunk, decay, cum) as ``ssd_intra_plain``.  A CUDA tensor
    goes to a kernel or raises; only a tensor that lies elsewhere (CPU, meta)
    takes the plain version."""
    if xh.device.type != "cuda":
        return ssd_intra_plain(xh, dt, A, Bp, Cp, chunk)
    refuse_dtensor("ssd_intra", xh, dt, A, Bp, Cp)
    refuse_grad("ssd_intra", xh, dt, A, Bp, Cp)
    _check(xh, dt, A, Bp, Cp)
    b, s, nh, hp = xh.shape
    dtype = xh.dtype if _tc_vec(xh, Bp, Cp) else torch.float32
    plan = ssd_plan(b, s, nh, hp, Bp.shape[-1], chunk, dtype)
    return launch_with_plan(xh, dt, A, Bp, Cp, chunk, plan)


def launch_with_plan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bp: torch.Tensor, Cp: torch.Tensor, chunk: int,
                     plan: SsdPlan) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel of ``plan`` on inputs that ``ssd_intra`` has
    checked (the "f32" route takes both dtypes)."""
    b, s, nh, hp = xh.shape
    n = Bp.shape[-1]
    q, nc = plan.q, plan.nc
    lib = build.load()
    y = torch.empty((b, s, nh, hp), dtype=torch.float32, device=xh.device)
    s_chunk = torch.empty((b, nc, nh, hp, n), dtype=torch.float32,
                          device=xh.device)
    decay = torch.empty((b, nc, nh), dtype=torch.float32, device=xh.device)
    cum = torch.empty((b, nc, q, nh), dtype=torch.float32, device=xh.device)
    ptrs = (xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bp.data_ptr(),
            Cp.data_ptr(), y.data_ptr(), s_chunk.data_ptr(), decay.data_ptr(),
            cum.data_ptr())
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "tc":
            err = lib.rt_ssd_intra_tc(*ptrs, b, s, nh, hp, n, q,
                                      plan.heads_per_block, int(plan.pair),
                                      _tc_vec(xh, Bp, Cp), stream)
        else:
            err = lib.rt_ssd_intra(*ptrs, b, s, nh, hp, n, q,
                                   DTYPE_CODES[xh.dtype], stream)
    build.check(err, "ssd_intra")
    build.count_launch("ssd_intra")
    return y, s_chunk, decay, cum
