# Counterpart of src/repro/core/blocks_lm.py: the dense, SSM and hybrid
# branches.  Not ported yet: the MoE and enc-dec branches with their virtual
# blocks, and `_train_scale` (the traced forward+backward ratio of the
# training step).
"""Per-architecture BlockTable construction (the "interval analysis pass").

This is the analogue of the paper's LLVM pass walking the IR: each model
block is traced once on ``meta`` tensors (shapes and dtypes only, no
allocation even at full width), its ATen op count is recorded as the block's
IR size, and the step's hook-stream program is laid out.  The trace runs on
tensors that are not on the card, so it goes through the kernels' plain
versions (K3's included, with ``ssm_impl="cuda"``) and never reaches a
kernel launch.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.configs.base import ShapeConfig, dtype_of
from repro_torch.core.registry import BlockDef, BlockTable, Segment
from repro_torch.core.unit_of_work import IRCost, trace_cost
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import Model


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _spec_struct(specs, dtype):
    """ParamSpec tree -> meta-tensor tree (zero-cost tracing inputs)."""
    return L.map_specs(lambda s: _meta(s.shape, dtype), specs)


def head_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The head block's loss term: cross-entropy with z-loss, written out as
    in the reference so that the head block has the same meaning there and
    here.  (The training slice brings `model_zoo.cross_entropy` proper.)"""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    onehot = torch.nn.functional.one_hot(labels.long(), lf.shape[-1]).float()
    nll = lse - torch.sum(lf * onehot, dim=-1)
    return torch.mean(nll) + 1e-4 * torch.mean(torch.square(lse))


def block_functions(model: Model, shape: ShapeConfig):
    """[(name, fn, meta args)] of the step's blocks, in program order."""
    cfg, dims = model.cfg, model.dims
    dt = dtype_of(cfg.compute_dtype)
    b = max(shape.global_batch, 1)
    s = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model
    x = _meta((b, s, d), dt)
    pos = _meta((b, s), torch.int32)
    toks = _meta((b, s), torch.int32)
    lp = _spec_struct(T.layer_specs(cfg, dims), dt)
    emb_sp = {"embedding": _meta((dims.vocab_pad, d), dt)}
    head_sp = {"norm": {"scale": _meta((d,), dt)},
               "head": _meta((d, dims.vocab_pad), dt)}

    def head_fn(p, xx, lbl):
        h = L.rmsnorm(p["norm"], xx, cfg.norm_eps)
        return head_loss(h.to(dt) @ p["head"], lbl)

    blocks = [("embed", lambda p, t: L.embed_lookup(p, t, dt), (emb_sp, toks))]
    if cfg.family in ("ssm", "hybrid"):
        blocks.append(("mamba", lambda p, xx: T.ssm_layer(p, cfg, xx)[0],
                       (lp, x)))
    if cfg.family == "hybrid":
        sh_sp = _spec_struct(T.shared_attn_specs(cfg, dims), dt)
        blocks.append(("shared_attn", lambda p, xx, pp: T._shared_attn_block(
            {"shared_attn": p}, cfg, dims, xx, pp)[0], (sh_sp, x, pos)))
    if cfg.family == "dense":
        blocks += [
            ("attn", lambda p, xx, pp: T._attn_block(
                p, cfg, dims, xx, pp, -1, plus_one=False, aux={})[0],
             (lp, x, pos)),
            ("mlp", lambda p, xx: T._mlp_block(p, cfg, xx, plus_one=False,
                                               aux={}), (lp, x)),
        ]
    return blocks + [("head", head_fn, (head_sp, x, toks))]


def build_block_table(model: Model, shape: ShapeConfig,
                      *, train: bool = True, unit: str = "ops") -> BlockTable:
    """``unit``: "ops" counts executed ATen calls (the LLVM-IR-instruction
    analogue; exact for homogeneous step streams); "flops" weighs each block
    by its traced FLOPs — the pluggable unit-of-work choice (paper §III-A)
    needed when steps are heterogeneous in tensor volume (serving: a prefill
    must out-weigh a 1-token decode even though both lower to the same number
    of ops).  The decode table is traced through the attention block at
    ``s = 1``, not over the cache, as in the reference."""
    cfg = model.cfg
    T.require_ported(cfg)
    if train and shape.kind == "train":
        raise NotImplementedError(
            "the training-step table (fwd+bwd scaling) is not ported yet: "
            "see ROADMAP.md, Queue A, item 'training'")
    costs = {name: trace_cost(fn, *args)
             for name, fn, args in block_functions(model, shape)}

    blocks: List[BlockDef] = []

    def add(name: str) -> int:
        cost: IRCost = costs[name]
        blocks.append(BlockDef(name, cost.ops, cost.flops))
        return len(blocks) - 1

    prog: List[Segment] = [Segment((add("embed"),), 1)]
    if cfg.family == "ssm":
        prog.append(Segment((add("mamba"),), cfg.n_layers))
    elif cfg.family == "hybrid":
        i_ssm, i_sh = add("mamba"), add("shared_attn")
        ae, n_groups, rem = T._hybrid_groups(cfg)
        for _ in range(n_groups):
            prog.append(Segment((i_ssm,), ae))
            prog.append(Segment((i_sh,), 1))
        if rem:
            prog.append(Segment((i_ssm,), rem))
    else:
        i_attn, i_mlp = add("attn"), add("mlp")
        prog.append(Segment((i_attn, i_mlp), cfg.n_layers))
    prog.append(Segment((add("head"),), 1))

    if unit == "flops":
        blocks = [dataclasses.replace(
            bl, cost_ops=max(1.0, bl.cost_flops)) for bl in blocks]
    return BlockTable(blocks, prog)
