# Counterpart of src/repro/optim/adamw.py; nothing of it is left unported.
# Where the reference returns new trees (and `jax.jit` donates the old
# buffers), `adamw_update` updates the parameters and the optimizer state in
# place.  On DTensor leaves (a sharded train state) it runs leaf by leaf as
# DTensor ops; the global norm is read with an explicit `full_tensor()` of
# each leaf's sum of squares, and the step stays a plain tensor.
"""AdamW with bf16 params + f32 master copy & moments.

The update runs leaf by leaf after one global norm, so at most one leaf's
gradient exists in f32 at a time besides the moments (at qwen3-1.7b's full
width an f32 copy of every gradient at once would be 6.9 GB).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.distributed.sharding import to_plain
from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    use_master: bool = True      # keep f32 master when params are bf16


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar on the params' device
    mu: Any
    nu: Any
    master: Any                  # f32 copy (or an empty tensor per leaf)


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    def zeros(p):
        # zeros_like: a DTensor leaf gets moments with its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                requires_grad=False)

    if cfg.use_master:
        master = tree_map(lambda p: p.detach().float().clone(), params)
    else:
        master = tree_map(lambda p: torch.zeros((0,), device=p.device),
                          params)
    leaf = tree_leaves(params)[0]
    return OptState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                    tree_map(zeros, params), tree_map(zeros, params), master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (no f32 copy of a
    bf16 leaf is kept).  A DTensor leaf's sum is gathered to a plain scalar
    (a collective), so the norm is a plain tensor."""
    sq = [to_plain(torch.sum(torch.square(x.float())))
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig,
                 lr: torch.Tensor) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step on ``params`` (nested dict of tensors, updated in
    place) from ``grads`` (the same tree, any float dtype).  Returns
    (params, state, {"grad_norm", "lr"}); ``state`` is updated in place."""
    p_leaves: List[torch.Tensor] = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
    master = tree_leaves(state.master)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    state.step.add_(1)
    step = state.step.float()
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
        g32 = g.float()
        if scale is not None:
            g32 = g32 * scale
        mu[i].mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        nu[i].mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        del g32
        # an f32 leaf without a master copy is updated in place
        w = master[i] if cfg.use_master else p.float()
        upd = mu[i] / b1c
        upd.div_(torch.sqrt(nu[i] / b2c).add_(cfg.eps))
        upd.add_(cfg.weight_decay * w)
        w.sub_(upd.mul_(lr))
        if w is not p:
            p.copy_(w)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(param_axes, cfg: AdamWConfig):
    """Logical axes for the optimizer state (mirrors param sharding)."""
    empty = tree_map(lambda a: a if cfg.use_master else (None,), param_axes)
    return OptState((), param_axes, param_axes, empty)
