# Counterpart of src/repro/models/moe.py; nothing of it is left unported.
# Router jitter is drawn from a `torch.Generator`, where the reference draws
# from a threefry key: the values differ, the rule (normal noise times
# `router_jitter`) does not.  Under a sharding plan (DTensor activations) the
# dispatch is redistributed around: DTensor has no sharding strategy for
# `searchsorted`, and the scatter (`index_add_`) and the gather back index a
# dim that the experts' sharding splits.  So `dispatch_indices`, the scatter
# and the combine run on each rank's own batch rows with every expert
# whole (`local_part`: an all-gather of the expert outputs over "model"),
# per batch row as the reference's dispatch is; the expert buffers between
# them are DTensors under the reference's `shard(...)` constraints, and
# the expert products run as DTensor ops.  The router's top-k runs on each
# rank's rows too, and the aux loss's means and the router's statistics
# come back as sums over the ranks' rows.
"""Mixture-of-Experts layer: top-k routing, capacity-bounded sorted dispatch.

Dispatch is *per batch row* (buffers [B, E, C, d]), as in the reference:
each row's tokens are sorted by expert, stably, so that within an expert the
earlier (token, k) entries take the slots and the later ones beyond its
capacity are dropped.  Router statistics (tokens per expert before the drop,
dropped tokens) are returned as the dynamic Nugget-signature entries.

Ties in the router's top-k go to the lower expert index, as
``jax.lax.top_k`` gives them: ``torch.topk(..., sorted=True)`` on the CPU
and on the card returns equal values in index order.  With f32 random
weights ties do not occur in practice.

The layer's phases are labelled ``nugget_block_moe.route``, ``.dispatch``,
``.experts`` and ``.combine`` (`layers.scope`), and each call adds its
routed (token, expert) entries to the registry's ``moe.entries`` and the
buffer rows its products run over to ``moe.slots`` (host integers from
shapes; not under a ``make_fx`` trace or fake tensors).

The scatter into the expert buffers is ``index_add_``.  A dropped entry adds
``token * 0`` to its expert's last slot, so the result does not depend on
the order of the adds unless a token holds inf or NaN.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.distributed.sharding import (from_local_part, local_part,
                                              shard)
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec


def moe_specs(cfg: ArchConfig) -> Dict[str, Any]:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_expert
    specs: Dict[str, Any] = {
        "router": {"kernel": ParamSpec((d, m.n_experts), ("embed", "experts"),
                                       "scaled")},
        "wi": ParamSpec((m.n_experts, d, fe), ("experts", "embed", "expert_mlp"),
                        "scaled"),
        "wo": ParamSpec((m.n_experts, fe, d), ("experts", "expert_mlp", "embed"),
                        "scaled"),
    }
    if cfg.glu:
        specs["wg"] = ParamSpec((m.n_experts, d, fe),
                                ("experts", "embed", "expert_mlp"), "scaled")
    if m.n_shared_experts:
        specs["shared"] = L.mlp_specs(d, cfg.d_ff, glu=cfg.glu)
    return specs


def capacity(seq_len: int, m: MoEConfig) -> int:
    c = int(math.ceil(seq_len * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)          # padded to 8, as the reference


def route(router_params, x: torch.Tensor, m: MoEConfig,
          rng: Optional[torch.Generator] = None):
    """x: [B,S,d] -> (expert ids [B,S,k] int64, gates [B,S,k] f32, aux).
    ``rng``: where the router's jitter is drawn from, when
    ``m.router_jitter > 0``.  DTensor logits route on this rank's rows as
    plain tensors (each row routes alone); the aux loss's means are then
    sums over the ranks that split the rows."""
    logits = L.dense(router_params, x, torch.float32)        # [B,S,E]
    top_e, top_g, gates_full, first, noisy = _top_k(local_part(logits, x),
                                                    m, rng)
    if isinstance(logits, DTensor):
        n = logits.shape[0] * logits.shape[1]
        me, ce = (from_local_part(torch.sum(t.reshape(-1, m.n_experts), 0),
                                  x, partial=True) / n
                  for t in (gates_full, first))
        top_e, top_g = from_local_part(top_e, x), from_local_part(top_g, x)
    else:
        me = torch.mean(gates_full.reshape(-1, m.n_experts), dim=0)
        ce = torch.mean(first.reshape(-1, m.n_experts), dim=0)
        logits = noisy
    # load-balancing aux loss (Switch-style) on the first choice
    aux_loss = m.n_experts * torch.sum(me * ce) * m.aux_loss_coef
    return top_e, top_g, {"router_aux_loss": aux_loss,
                          "router_logits_max": torch.amax(torch.abs(logits))}


def _top_k(logits: torch.Tensor, m: MoEConfig,
           rng: Optional[torch.Generator]):
    """(expert ids, renormalised gates, the softmax over every expert, the
    first choice one-hot, the logits with the jitter) of plain logits."""
    if rng is not None and m.router_jitter > 0:
        noise = torch.randn(logits.shape, generator=rng, dtype=torch.float32,
                            device=rng.device).to(logits.device)
        logits = logits + m.router_jitter * noise
    gates_full = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates_full, m.top_k, dim=-1, sorted=True)
    top_g = top_g / torch.clamp(torch.sum(top_g, -1, keepdim=True), min=1e-9)
    first = torch.nn.functional.one_hot(top_e[..., 0], m.n_experts).float()
    return top_e, top_g, gates_full, first, logits


def dispatch_indices(top_e: torch.Tensor, k: int, n_experts: int, cap: int):
    """Sorted capacity-bounded slotting, per batch row.

    top_e: [B, S, k] expert ids -> (slot [B, S*k] int64 in [0, E*cap),
    keep [B, S*k] bool).  Entries beyond an expert's capacity are dropped
    (standard capacity-factor semantics); a dropped entry's slot is its
    expert's last."""
    b = top_e.shape[0]
    flat_e = top_e.reshape(b, -1)                              # [B, S*k]
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=top_e.device,
                           dtype=sorted_e.dtype).expand(b, n_experts)
    start = torch.searchsorted(sorted_e.contiguous(), experts.contiguous(),
                               side="left")                    # [B, E]
    pos = (torch.arange(n, device=top_e.device)[None]
           - torch.gather(start, 1, sorted_e))
    keep_sorted = pos < cap
    slot_sorted = sorted_e * cap + torch.clamp(pos, max=cap - 1)
    # unsort back to (token, k) order: the inverse permutation of `order`
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    return slot, keep


def expert_mlp(params, cfg: ArchConfig, buf: torch.Tensor) -> torch.Tensor:
    """The experts' MLPs over their buffers: [B, E, C, d] -> [B, E, C, d].
    The reference's ``becd,edf->becf`` products, as one batched product per
    weight over the expert axis."""
    b, e, c, d = buf.shape
    dtype = buf.dtype
    xb = buf.transpose(0, 1).reshape(e, b * c, d)
    h = torch.bmm(xb, params["wi"].to(dtype))
    h = L.ACTS[cfg.act](h)
    if "wg" in params:
        h = h * torch.bmm(xb, params["wg"].to(dtype))
    out = torch.bmm(h, params["wo"].to(dtype))                 # [E, B*C, d]
    return out.reshape(e, b, c, d).transpose(0, 1)


def moe_mlp(params, cfg: ArchConfig, x: torch.Tensor, *,
            rng: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.moe
    s, d = x.shape[1:]
    cap = capacity(s, m)
    dtype = x.dtype

    with L.scope("nugget_block_moe.route"):
        top_e, top_g, aux = route(params["router"], x, m, rng)
    with L.scope("nugget_block_moe.dispatch"):
        # this rank's batch rows (all of them on one device)
        x_l, e_l, g_l = (local_part(t, x) for t in (x, top_e, top_g))
        bl = x_l.shape[0]
        slot, keep = dispatch_indices(e_l, m.top_k, m.n_experts, cap)

        # scatter tokens into the expert buffers [B, E*cap, d]
        tok = torch.repeat_interleave(x_l, m.top_k, dim=1)     # [B, S*k, d]
        rows = torch.arange(bl, device=x.device)[:, None] * (m.n_experts * cap)
        buf = torch.zeros((bl * m.n_experts * cap, d), dtype=dtype,
                          device=x.device)
        wmask = keep[..., None].to(dtype)
        buf.index_add_(0, (rows + slot).reshape(-1),
                       (tok * wmask).reshape(-1, d))
        buf = from_local_part(buf.reshape(bl, m.n_experts, cap, d), x)
        buf = shard(buf, "batch", "experts", None, None)
    if not obs.tracing():
        # the products' work, from shapes: the routed entries and the
        # buffer rows they run over (this rank's rows)
        reg = obs.metrics()
        reg.count("moe.entries", bl * s * m.top_k)
        reg.count("moe.slots", bl * m.n_experts * cap)
    with L.scope("nugget_block_moe.experts"):
        out_buf = expert_mlp(params, cfg, buf)
        out_buf = shard(out_buf, "batch", "experts", None, None)
        out_buf = local_part(out_buf, x).reshape(bl, m.n_experts * cap, d)

    with L.scope("nugget_block_moe.combine"):
        # gather back and combine with the gates
        gathered = torch.gather(out_buf, 1, slot[..., None].expand(bl, -1, d))
        gathered = gathered * (keep[..., None].to(dtype) *
                               g_l.reshape(bl, -1)[..., None].to(dtype))
        y = from_local_part(
            torch.sum(gathered.reshape(bl, s, m.top_k, d), dim=2), x)

        if m.n_shared_experts:
            y = y + L.mlp(params["shared"], x, cfg.act, dtype)

        # ---- dynamic Nugget-signature entries ---------------------------
        flat = e_l.reshape(-1)
        counts = torch.zeros((m.n_experts,), dtype=torch.int32,
                             device=x.device).index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))  # [E]
        aux["expert_tokens"] = from_local_part(counts, x, partial=True)
        aux["dropped_tokens"] = from_local_part(
            torch.sum(~keep).to(torch.int32), x, partial=True)
    return shard(y, "batch", "seq", "act_embed"), aux


def layer_generator(rng: Optional[torch.Generator], layer: int
                    ) -> Optional[torch.Generator]:
    """Layer ``layer``'s jitter stream, derived from ``rng``'s seed (the
    reference splits its key once per layer).  Made afresh on every call, so
    a rematerialised layer draws the same jitter again."""
    if rng is None:
        return None
    seed = (rng.initial_seed() * 1_000_003 + layer) % (2 ** 63)
    return torch.Generator(device=rng.device).manual_seed(seed)
