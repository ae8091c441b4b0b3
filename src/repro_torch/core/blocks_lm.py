# Counterpart of src/repro/core/blocks_lm.py; nothing of it is left
# unported.  The train-step scaling is a traced ratio where the reference's
# always falls back to 3.0 (ROADMAP.md, faults of the reference).
"""Per-architecture BlockTable construction (the "interval analysis pass").

This is the analogue of the paper's LLVM pass walking the IR: each model
block is traced once on ``meta`` tensors (shapes and dtypes only, no
allocation even at full width), its ATen op count is recorded as the block's
IR size, and the step's hook-stream program is laid out.  Training steps
scale block costs by the traced grad/fwd ratio so the unit of work covers the
whole executed step (forward hook positions).  The trace runs on
tensors that are not on the card, so it goes through the kernels' plain
versions (K3's included, with ``ssm_impl="cuda"``) and never reaches a
kernel launch.  The MoE block is the expert layer alone, without its norm
and residual, as the reference traces it; its dispatch (argsort,
searchsorted, the scatter) traces on meta tensors like any other op.  The
enc-dec family has an ``enc_layer`` block (over ``n_frames`` positions,
non-causal) and a ``dec_layer`` block (causal self-attention,
cross-attention to an encoder output of ``n_frames`` positions, MLP); the
VLM's blocks are the dense family's (the patch projection is not traced, as
in the reference).  An MoE stack that leads with dense layers (the port's
``n_dense_layers``) has an ``mlp`` block too, before the ``moe`` layers; a
latent-attention block is traced in its prefill (expanded) form.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import torch

from repro_torch.configs.base import (ArchConfig, ShapeConfig, dtype_of,
                                      reduced)
from repro_torch.core.registry import BlockDef, BlockTable, Segment
from repro_torch.core.unit_of_work import IRCost, trace_cost
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import Model, build_model, cross_entropy


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _spec_struct(specs, dtype):
    """ParamSpec tree -> meta-tensor tree (zero-cost tracing inputs)."""
    return L.map_specs(lambda s: _meta(s.shape, dtype), specs)


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
    emb_sp = {"embedding": _meta((dims.vocab_pad, d), dt)}
    head_sp = {"norm": {"scale": _meta((d,), dt)},
               "head": _meta((d, dims.vocab_pad), dt)}

    def head_fn(p, xx, lbl):
        h = L.rmsnorm(p["norm"], xx, cfg.norm_eps)
        return cross_entropy(h.to(dt) @ p["head"], lbl, cfg.vocab_size)[0]

    blocks = [("embed", lambda p, t: L.embed_lookup(p, t, dt), (emb_sp, toks))]
    if cfg.family == "encdec":
        xe = _meta((b, cfg.n_frames, d), dt)
        pe = _meta((b, cfg.n_frames), torch.int32)
        enc_sp = _spec_struct(ED._enc_layer_specs(cfg, dims), dt)
        dec_sp = _spec_struct(ED._dec_layer_specs(cfg, dims), dt)
        blocks.append(("enc_layer", lambda p, xx, pp: ED.enc_layer(
            p, cfg, dims, xx, pp, dt), (enc_sp, xe, pe)))
        blocks.append(("dec_layer", lambda p, xx, pp, eo: ED.dec_layer(
            p, cfg, dims, xx, pp, eo, dt)[0], (dec_sp, x, pos, xe)))
        return blocks + [("head", head_fn, (head_sp, x, toks))]
    lp = _spec_struct(T.layer_specs(cfg, dims), dt)
    if cfg.family in ("ssm", "hybrid"):
        blocks.append(("mamba", lambda p, xx: T.ssm_layer(p, cfg, xx)[0],
                       (lp, x)))
    if cfg.family == "hybrid":
        sh_sp = _spec_struct(T.shared_attn_specs(cfg, dims), dt)
        blocks.append(("shared_attn", lambda p, xx, pp: T._shared_attn_block(
            {"shared_attn": p}, cfg, dims, xx, pp)[0], (sh_sp, x, pos)))
    if cfg.family in ("dense", "moe", "vlm"):
        blocks.append(("attn", lambda p, xx, pp: T._attn_block(
            p, cfg, dims, xx, pp, -1, plus_one=False, aux={})[0],
            (lp, x, pos)))
    if cfg.family in ("dense", "vlm") or cfg.n_dense_layers:
        dp = (_spec_struct(T.layer_specs(cfg, dims, dense=True), dt)
              if cfg.n_dense_layers else lp)
        blocks.append(("mlp", lambda p, xx: T._mlp_block(
            p, cfg, xx, plus_one=False, aux={}), (dp, x)))
    if cfg.family == "moe":
        blocks.append(("moe", lambda p, xx: M.moe_mlp(p["moe"], cfg, xx)[0],
                       (lp, x)))
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
    costs = {name: trace_cost(fn, *args)
             for name, fn, args in block_functions(model, shape)}

    blocks: List[BlockDef] = []

    def add(name: str, **kw) -> int:
        cost: IRCost = costs.get(name, IRCost(0, 0, 0))
        blocks.append(BlockDef(name, cost.ops, cost.flops, **kw))
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
    elif cfg.family == "encdec":
        prog.append(Segment((add("enc_layer"),), cfg.n_enc_layers))
        prog.append(Segment((add("dec_layer"),), cfg.n_layers))
    else:
        i_attn = add("attn")
        if cfg.n_dense_layers:
            prog.append(Segment((i_attn, add("mlp")), cfg.n_dense_layers))
        i_mlp = add("moe" if cfg.family == "moe" else "mlp")
        prog.append(Segment((i_attn, i_mlp),
                            cfg.n_layers - cfg.n_dense_layers))
    prog.append(Segment((add("head"),), 1))

    # ---- virtual (signature-only) blocks -----------------------------------
    if cfg.family == "moe":
        for e in range(cfg.moe.n_experts):
            add(f"expert_tok_{e}", virtual=True, dyn_key="expert_tokens",
                dyn_index=e)
        add("dropped_tokens", virtual=True, dyn_key="dropped_tokens")

    if unit == "flops":
        blocks = [dataclasses.replace(
            bl, cost_ops=max(1.0, bl.cost_flops)) for bl in blocks]
    table = BlockTable(blocks, prog)

    # ---- train-step scaling (fwd+bwd+optimizer coverage) -------------------
    if train and shape.kind == "train":
        scale = _train_scale(model)
        table = BlockTable(
            [dataclasses.replace(bl, cost_ops=bl.cost_ops * scale,
                                 cost_flops=bl.cost_flops * scale)
             for bl in table.blocks], table.program)
    return table


def train_scale_traced(cfg: ArchConfig) -> float:
    """Traced grad/fwd ATen-op ratio of the loss of a reduced clone of
    ``cfg``, on meta tensors.  The grad trace holds the rematerialised
    forward, as the executed backward does."""
    return _traced_ratio(reduced(cfg))


@functools.lru_cache(maxsize=32)
def _traced_ratio(cfg_r: ArchConfig) -> float:
    """One trace per reduced config (equal configs share it)."""
    m_r = build_model(cfg_r, device="meta")
    dt = dtype_of(cfg_r.param_dtype)
    toks = _meta((2, 16), torch.int64)
    stubs = {}
    if cfg_r.family == "encdec":
        stubs["frames"] = _meta((2, cfg_r.n_frames, cfg_r.d_model),
                                torch.float32)
    if cfg_r.n_patches:
        stubs["patches"] = _meta((2, cfg_r.n_patches, cfg_r.d_model),
                                 torch.float32)

    def loss(p, t):
        return m_r.loss(p, {"tokens": t, "labels": t, **stubs})[0]

    def grad(p, t):
        with torch.enable_grad():
            return torch.autograd.grad(loss(p, t), L.tree_leaves(p))

    fwd = trace_cost(loss, _spec_struct(m_r.specs(), dt), toks)
    sp = L.map_specs(lambda s: _meta(s.shape, dt).requires_grad_(),
                     m_r.specs())
    bwd = trace_cost(grad, sp, toks)
    # a multiple of 1/1024, so that every scaled cost (an integer op count
    # times the ratio) and every sum of them is exact in float64, as the
    # reference's integer costs are.  With an inexact ratio a step's running
    # sum can round just below k * interval_uow, and the interval analysis
    # then closes that boundary again one block into the next step.
    return max(1.0, round(bwd.ops / max(fwd.ops, 1.0) * 1024) / 1024)


def _train_scale(model: Model) -> float:
    """``train_scale_traced``, or the reference's fallback of 3.0 where the
    trace fails."""
    try:
        return train_scale_traced(model.cfg)
    except Exception:
        return 3.0
