# Counterpart of src/repro/kernels/flash_attention.py (`flash_attention`,
# body `_flash_kernel`).  Forward only, as there; the backward waits for the
# training slice.
"""Flash attention forward (GQA, causal, sliding window, soft-cap): a CUDA
kernel written by hand for Hopper, its plain PyTorch version, and the wrapper
that chooses between them by where the tensor lies.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_flash_kernel``.  On this card the function is bound by operations: at the
serving path's prefill shape the three inputs and the output are a few
megabytes, the two products a few hundred MFLOP.  The design keeps the scores
and the weights out of device memory (online softmax over kv tiles inside one
block per (batch, q head, q tile), running max / sum / accumulator in
registers), skips the kv tiles that the causal frontier and the window mask
out, and masks the ragged edge in the kernel instead of padding the inputs.
This first version does both products in IEEE f32 on the CUDA cores; moving
them to the tensor cores is what is left between it and the bound.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Window = Union[int, torch.Tensor, None]


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
                          window: Window = None,
                          cap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version.  q: [B,S,H,hd]; k/v: [B,Sk,KV,hd], H = KV*group.
    f32 inside, out in q's type; masked scores are the finite -1e30."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = gqa_scores(q, k, group) / math.sqrt(hd)
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


def check_inputs(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """What the CUDA kernels take: one CUDA device, f32 or bf16 throughout,
    contiguous, 16-byte aligned, a head_dim the kernels are built for."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16 only)")
    if q.shape[-1] not in HEAD_DIMS:
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
                    cap: float = 0.0) -> torch.Tensor:
    """q: [B,S,H,hd]; k/v: [B,S,KV,hd] with H = KV*group.  Positions are
    arange (rope applied by the caller).  A CUDA tensor goes to the kernel or
    raises; only a tensor that lies elsewhere (CPU, meta) takes the plain
    version."""
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, group=group, causal=causal,
                                     window=window, cap=cap)
    check_inputs("flash_attention", q, k, v)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape != (b, s, kv, hd) or v.shape != k.shape or h != kv * group:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"group {group}")
    win = window_arg("flash_attention", window)
    lib = build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, kv, hd, DTYPE_CODES[q.dtype], int(bool(causal)), win,
            float(cap), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0      # kernel launches made by the wrapper
