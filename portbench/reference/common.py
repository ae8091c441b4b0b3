"""Plain operations shared by the references: float32 products, or float8
(e4m3) ones for the precision control.

Nothing here imports the program.  ``prec`` is ``"f32"`` (float32 operands,
TF32 off) or ``"fp8"``: each operand of a product is rounded to float8 e4m3
with one scale for the whole tensor (its largest magnitude over 448) and
multiplied in float32, the rounding an fp8 serving path would add.
"""
from __future__ import annotations

import math

import torch

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32: the card would otherwise use TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3 under one per-tensor scale."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "fp8":
        return fp8_round(x)
    raise ValueError(f"unknown precision {prec!r}; choose from {PRECISIONS}")


def mm(a: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ w`` with both operands in ``prec``."""
    return operand(a, prec) @ operand(w, prec)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` [T, H, hd] at positions 0..T-1, the two
    halves of the head rotated together (not interleaved pairs)."""
    t, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: str) -> torch.Tensor:
    """Softmax attention of ``q, k, v`` [T, H, hd], each position over itself
    and those before it; float32 softmax."""
    t, _, hd = q.shape
    s = torch.einsum("thd,shd->hts", operand(q, prec), operand(k, prec))
    s = s / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hts,shd->thd", operand(p, prec), operand(v, prec))


# ---------------------------------------------------------------------------
# Weights: drawn on the device from the seed, in a few large calls
# ---------------------------------------------------------------------------

def draw_normal_leaves(shapes_stds, gen: torch.Generator, device, dtype):
    """One standard-normal draw for every leaf of ``shapes_stds`` (a list of
    (shape, std)), carved into views and scaled in place; returns the
    views in the same order."""
    sizes = [math.prod(s) for s, _ in shapes_stds]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, at = [], 0
    for (shape, std), n in zip(shapes_stds, sizes):
        out.append(flat[at:at + n].view(shape).mul_(std))
        at += n
    return out


def set_path(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value
