# No counterpart in src/repro: the JAX package runs the experts' products as
# XLA einsums over capacity buffers (models/moe.py `moe_mlp`), and the port's
# buffer path does the same with batched products.  This kernel serves the
# decode step, where those buffers hold one routed entry in 64 rows.
"""The MoE layer's expert products over the routed (token, expert) entries
only, grouped by expert: a CUDA kernel written by hand for Hopper, its plain
PyTorch version, and the wrapper that chooses between them by where the
tensor lies.

It replaces no TPU kernel (the reference has no Pallas kernel for the
experts).  At decode a row routes one token to ``top_k`` different experts,
so no capacity can bind, and the buffer path's [B, E, C, d] buffers (C padded
to 8) are mostly zeros: 131 072 rows for 2 048 entries at olmoe-1b-7b's 256
rows.  Over the entries alone the products do about 32 flops per weight byte,
far under the card's ridge of about 295, so the kernel is bound by reading
each routed expert's weights once (``csrc/moe_grouped.cu``): a block takes
one (column tile, expert), finds its rows from the per-expert counts on the
device, gathers its tokens straight from ``x``, keeps three weight stages in
flight in a ``cp.async`` ring, multiplies by ``mma.sync`` with f32 sums, and
applies ``silu(x wi) * (x wg)`` in the up projection's epilogue; an expert
with no entry reads nothing.  The grids are fixed by the shapes, so nothing
reaches the host.

``sort_entries`` sorts the entries by expert on the device (stably; the
per-expert counts are the router statistics' own), ``grouped_mlp`` runs the
products, ``grouped_rows`` is the most rows the products can run over, from
shapes alone (the registry's ``moe.slots`` on this path).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import refuse_dtensor, refuse_grad

ROW_TILE = 16        # rows of an mma tile: the products' granularity
WIDTH_TILE = 64      # the kernel's column and depth tiles divide d and d_expert


def takes(glu: bool, act: str, dtype: torch.dtype, d: int, fe: int) -> bool:
    """Whether the kernel computes this MoE configuration: a gated SiLU MLP
    (``silu(x wi) * (x wg)``, then ``wo``) in bf16, at widths its tiles
    divide."""
    return (glu and act == "silu" and dtype == torch.bfloat16
            and d % WIDTH_TILE == 0 and fe % WIDTH_TILE == 0)


def grouped_rows(entries: int, n_experts: int) -> int:
    """The most rows the grouped products run over for ``entries`` routed
    entries over ``n_experts`` experts, from shapes alone: each expert's
    entries fill m16 tiles, so a route makes at most
    ``(entries + 15 * min(E, entries)) // 16`` of them (which count fills
    them depends on the route, which stays on the device)."""
    tiles = (entries + (ROW_TILE - 1) * min(n_experts, entries)) // ROW_TILE
    return tiles * ROW_TILE


def sort_entries(flat_e: torch.Tensor, counts: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_e: [N] expert ids of the entries in (token, k) order; counts: [E]
    int32 entries per expert -> (order [N] int64: the entries sorted by
    expert, stably; ends [E] int32: the running sum of the counts, expert
    e's entries being order[ends[e] - counts[e]:ends[e]])."""
    order = torch.argsort(flat_e, stable=True)
    return order, torch.cumsum(counts, 0, dtype=torch.int32)


def grouped_mlp_plain(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                      wo: torch.Tensor, order: torch.Tensor,
                      counts: torch.Tensor, ends: torch.Tensor, *,
                      top_k: int) -> torch.Tensor:
    """Plain PyTorch version: a loop over the experts on the sorted entries.
    x: [T, d]; wi, wg [E, d, fe]; wo [E, fe, d] -> [T * top_k, d], row i the
    output of entry i (token i // top_k).  Sums in f32, h rounded to x's
    dtype before the second product and the output once, as the kernel."""
    out = torch.zeros((order.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for e, (c, end) in enumerate(zip(counts.tolist(), ends.tolist())):
        if not c:
            continue
        idx = order[end - c:end]
        xe = x[idx // top_k].float()
        h = F.silu(xe @ wi[e].float()) * (xe @ wg[e].float())
        out[idx] = (h.to(x.dtype).float() @ wo[e].float()).to(x.dtype)
    return out


def grouped_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor, order: torch.Tensor, counts: torch.Tensor,
                ends: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """A CUDA tensor goes to the kernel or raises; only a tensor that lies
    elsewhere (CPU, meta) takes the plain version."""
    if x.device.type != "cuda":
        return grouped_mlp_plain(x, wi, wg, wo, order, counts, ends,
                                 top_k=top_k)
    refuse_dtensor("grouped_mlp", x, wi, wg, wo)
    refuse_grad("grouped_mlp", x, wi, wg, wo)
    t, d = x.shape
    e, _, fe = wi.shape
    n = order.shape[0]
    for name, ten, shape in (("x", x, (t, d)), ("wi", wi, (e, d, fe)),
                             ("wg", wg, (e, d, fe)), ("wo", wo, (e, fe, d))):
        if (ten.dtype != torch.bfloat16 or tuple(ten.shape) != shape
                or not ten.is_contiguous() or ten.device != x.device):
            raise ValueError(f"grouped_mlp: {name} must be a contiguous "
                             f"bfloat16 {list(shape)} tensor on {x.device}, "
                             f"not {ten.dtype} {list(ten.shape)}")
    for name, ten, dtype, size in (("order", order, torch.int64, t * top_k),
                                   ("counts", counts, torch.int32, e),
                                   ("ends", ends, torch.int32, e)):
        if (ten.dtype != dtype or tuple(ten.shape) != (size,)
                or not ten.is_contiguous() or ten.device != x.device):
            raise ValueError(f"grouped_mlp: {name} must be a contiguous "
                             f"{dtype} [{size}] tensor on {x.device}")
    if not takes(True, "silu", x.dtype, d, fe):
        raise ValueError(f"grouped_mlp: widths d {d}, d_expert {fe} are not "
                         f"multiples of {WIDTH_TILE}")
    lib = build.load()
    h = torch.empty((n, fe), dtype=x.dtype, device=x.device)
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.rt_moe_grouped(
            x.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
            h.data_ptr(), out.data_ptr(), order.data_ptr(), counts.data_ptr(),
            ends.data_ptr(), e, d, fe, top_k,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "grouped_mlp")
    build.count_launch("grouped_mlp")
    return out
