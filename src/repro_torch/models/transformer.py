# Counterpart of src/repro/models/transformer.py: the dense, MoE, SSM,
# hybrid and VLM families (the enc-dec family is models/encdec.py); nothing
# of it is left unported.  The reference's ``jax.named_scope`` block labels
# are `layers.scope` ranges (`obs.span`s), which a profile and the program's
# trace see; the attention block's phases have labels of their own.  The
# `shard(...)` constraints are identities unless a plan is active and the
# tensor is a DTensor (distributed/sharding.py).  The router's `rng` is a
# `torch.Generator` (see models/moe.py).  The port's own: latent attention
# (`models/mla.py`, where ``cfg.mla`` is set) in the attention block, and an
# MoE stack that leads with ``n_dense_layers`` dense layers, stacked apart
# under ``dense_layers``.
"""Decoder-only LM covering the dense, MoE, SSM, hybrid and VLM families.

Parameters keep the reference's layout: the layers' leaves are stacked on a
leading "layer" axis.  The reference scans over that axis; here it is a Python
loop over the per-layer views that ``split_layers`` makes once per forward.
With grad enabled each layer (or group of ``remat_group`` layers) is
rematerialised in the backward, as the reference's ``_maybe_remat`` does.
Per-layer static attention windows (gemma3's 5:1 local:global) ride along as
Python ints.  The VLM's projected patch embeddings (``patch_proj``) replace
the first ``n_patches`` token embeddings.  An MoE layer's router statistics
and auxiliary loss are summed over the layers into the forward's ``aux``.  Hybrid (zamba2) runs groups of
``attn_every`` Mamba2 layers with one SHARED attention block after each group
(its parameters live outside the stack and are reused).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, dtype_of
from repro_torch.distributed.sharding import active_rules, shard, use_rules
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.attention import HeadLayout
from repro_torch.models.layers import ParamSpec

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg: ArchConfig) -> None:
    """Raise, naming the reason, for what the port does not run: a family
    it lacks, a weight quantization the reference has not (int8 and int4
    run), and the enc-dec family with an int8 cache (the reference casts its
    k/v to int8 with no scale; ROADMAP.md, faults of the reference)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported (ROADMAP.md)")
    if cfg.weight_quant not in ("none", "int8", "int4"):
        raise NotImplementedError(
            f"weight_quant={cfg.weight_quant!r}: the reference has 'int8' "
            "and 'int4'")
    if cfg.cache_quant == "int8" and cfg.family == "encdec":
        raise NotImplementedError(
            "the enc-dec family with an int8 KV cache: the reference casts "
            "its k/v to int8 with no scale (src/repro/models/encdec.py, "
            "encdec_prefill and encdec_decode), a fault the port does not "
            "copy (ROADMAP.md, faults of the reference)")


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Mesh-dependent derived dimensions (head/vocab padding)."""
    tp: int
    layout: Optional[HeadLayout]
    vocab_pad: int

    @staticmethod
    def make(cfg: ArchConfig, tp: int) -> "ModelDims":
        layout = HeadLayout.make(cfg.attn, tp) if cfg.attn else None
        vpad = tp * math.ceil(cfg.vocab_size / tp)
        return ModelDims(tp, layout, vpad)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def layer_specs(cfg: ArchConfig, dims: ModelDims, *,
                dense: bool = False) -> Dict[str, Any]:
    """One layer's specs; ``dense``: a leading dense layer of an MoE stack."""
    require_ported(cfg)
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"ssm_norm": L.rmsnorm_specs(d), "ssm": S.mamba2_specs(cfg)}
    specs: Dict[str, Any] = {
        "attn_norm": L.rmsnorm_specs(d),
        "attn": (MLA.mla_specs(cfg) if cfg.mla is not None
                 else A.attention_specs(cfg.attn, d, dims.layout)),
        "mlp_norm": L.rmsnorm_specs(d),
    }
    if cfg.family == "moe" and not dense:
        specs["moe"] = M.moe_specs(cfg)
    else:
        specs["mlp"] = L.mlp_specs(d, cfg.d_ff, glu=cfg.glu)
    return specs


def shared_attn_specs(cfg: ArchConfig, dims: ModelDims) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm": L.rmsnorm_specs(d),
        "attn": A.attention_specs(cfg.attn, d, dims.layout),
        "mlp_norm": L.rmsnorm_specs(d),
        "mlp": L.mlp_specs(d, cfg.d_ff, glu=cfg.glu),
    }


def lm_specs(cfg: ArchConfig, dims: ModelDims) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": {"embedding": ParamSpec((dims.vocab_pad, cfg.d_model),
                                         ("vocab", "embed"), "normal", 1.0)},
        "final_norm": L.rmsnorm_specs(cfg.d_model),
    }
    per_layer = layer_specs(cfg, dims)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    if cfg.n_dense_layers:
        if not cfg.scan_layers:
            raise NotImplementedError("leading dense layers are stacked "
                                      "(scan_layers=True)")
        specs["dense_layers"] = L.stack_specs(
            layer_specs(cfg, dims, dense=True), cfg.n_dense_layers)
    if cfg.scan_layers:
        specs["layers"] = L.stack_specs(per_layer, n_moe)
    else:
        specs["layers"] = {f"layer_{i}": per_layer for i in range(cfg.n_layers)}
    if cfg.family == "hybrid":
        specs["shared_attn"] = shared_attn_specs(cfg, dims)
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"kernel": ParamSpec(
            (cfg.d_model, dims.vocab_pad), ("embed", "vocab"), "scaled")}
    if cfg.n_patches:
        specs["patch_proj"] = L.dense_specs(cfg.d_model, cfg.d_model,
                                            ("embed", None))
    return specs


def layer_params(params, cfg: ArchConfig, i: int):
    """Parameters of layer ``i``: a slice of the stacked leaves (views); the
    leading dense layers come first."""
    nd = cfg.n_dense_layers
    if i < nd:
        return L.tree_index(params["dense_layers"], i)
    if cfg.scan_layers:
        return L.tree_index(params["layers"], i - nd)
    return params["layers"][f"layer_{i}"]


def split_layers(params, cfg: ArchConfig) -> List[Dict[str, Any]]:
    """Every layer's parameters, from one ``unbind`` of each stacked leaf
    (views).  Under autograd the backward of an ``unbind`` is one ``stack``;
    indexing the leaf once per layer would make each layer's backward build
    a zero gradient the size of the whole stacked leaf."""
    if not cfg.scan_layers:
        return [params["layers"][f"layer_{i}"] for i in range(cfg.n_layers)]
    nd = cfg.n_dense_layers
    dense = unstack(params["dense_layers"], nd) if nd else []
    return dense + unstack(params["layers"], cfg.n_layers - nd)


def unstack(stacked, n: int) -> List[Dict[str, Any]]:
    """The ``n`` per-layer trees of a tree of layer-stacked leaves (views,
    one ``unbind`` a leaf; see ``split_layers``)."""
    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        return tree.unbind(0)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    parts = split(stacked)
    return [pick(parts, i) for i in range(n)]


_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_PRODUCTS = {torch.ops.aten.bmm.default: 0,      # the batched operand
                     torch.ops.aten.baddbmm.default: 1}


def _saved_by_selective_remat(func, args) -> bool:
    """The reference's ``dots_with_no_batch_dims_saveable``: a product with
    no batch dims (the weight products: ``mm``, ``addmm``, and the ``bmm``
    over a batch of one that ``torch.einsum`` makes of a weight product
    with more output axes) is saved; everything else (attention's and the
    experts' batched products, elementwise ops) is recomputed."""
    if func in _WEIGHT_PRODUCTS:
        return True
    i = _BATCHED_PRODUCTS.get(func)
    return i is not None and args[i].shape[0] == 1


class _SaveProducts(TorchDispatchMode):
    """The forward of a selectively rematerialised region: keeps a detached
    alias of each saved product's output and its version, per op in call
    order."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _saved_by_selective_remat(func, args):
            kept = out.detach()
            self.store.setdefault(func, []).append((kept, kept._version))
        return out


class _ReuseProducts(TorchDispatchMode):
    """The region's recomputation in the backward: a saved product returns
    its kept output (the same call order) and runs no op; the rest runs.  A
    kept output that the forward changed in place since raises."""

    def __init__(self, store):
        super().__init__()
        self.store = store
        self.seen = {}

    def __enter__(self):
        self.seen = {}                 # each recomputation starts over
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _saved_by_selective_remat(func, args):
            return func(*args, **(kwargs or {}))
        i = self.seen.get(func, 0)
        self.seen[func] = i + 1
        kept, version = self.store[func][i]
        if kept._version != version:
            raise RuntimeError(f"selective remat: the saved output of {func} "
                               "was changed in place after it was saved")
        return kept


def _selective_contexts():
    """``checkpoint``'s ``context_fn`` for ``remat="selective"``.  (torch's
    ``create_selective_checkpoint_contexts`` takes a ``make_fx`` trace for a
    compile: there it keeps every op's output and leaves the choice to a
    compiler's partitioner, so a traced backward, which the unit of work and
    the dry-run price, would hold no recomputation at all, and the MoE
    dispatch's in-place scatter fails its cache check.  These two modes
    recompute the same way eagerly and under a trace.)"""
    store = {}
    return _SaveProducts(store), _ReuseProducts(store)


def _maybe_remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` recomputed in the backward when grad is enabled: all of it
    (``remat="full"``), or all but its products without batch dims
    (``"selective"``, `_saved_by_selective_remat`); as it is
    otherwise.  The recomputation runs under the sharding plan that is
    active now: the backward of CUDA tensors runs on another thread, which
    does not see this thread's plan, and without it the recomputed layer
    would place its tensors otherwise than the forward."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "selective"):
        raise NotImplementedError(
            f"remat={cfg.remat!r}: the reference has 'none', 'full' and "
            "'selective'")
    plan = active_rules()

    def under_plan(*args, **kw):
        with use_rules(plan):
            return fn(*args, **kw)
    kw = {"context_fn": _selective_contexts} if cfg.remat == "selective" \
        else {}
    return functools.partial(checkpoint, under_plan, use_reentrant=False,
                             **kw)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def rope_tables(cfg: ArchConfig, positions):
    """The rotary tables of a step's positions, shared by all its layers."""
    if cfg.mla is not None:
        return MLA.rope_tables(cfg, positions)
    return L.rope_tables(positions, cfg.attn.head_dim, cfg.attn.rope_theta)


def _attn_out(p, cfg: ArchConfig, dims: ModelDims, x, positions, window,
              *, plus_one: bool, rope=None):
    """norm -> qkv -> attention -> output projection; returns (y, (k, v)),
    with latent attention (y, (latent, None)).  Each phase is labelled
    (``nugget_block_attn.qkv``, ``.attend``, ``.out``)."""
    dt = x.dtype
    if cfg.mla is not None:
        if rope is None:
            rope = rope_tables(cfg, positions)
        with L.scope("nugget_block_attn.qkv"):
            h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps, plus_one=plus_one)
            q_nope, q_pe, latent = MLA.project(p["attn"], cfg, h, rope, dt)
        with L.scope("nugget_block_attn.attend"):
            ctx = MLA.attend_expanded(p["attn"], cfg, q_nope, q_pe, latent,
                                      dt)
        with L.scope("nugget_block_attn.out"):
            y = MLA.out_proj(p["attn"], ctx, dt)
        return y, (latent, None)
    with L.scope("nugget_block_attn.qkv"):
        h = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps, plus_one=plus_one)
        q, k, v = A.qkv(p["attn"], cfg.attn, dims.layout, h, positions, dt,
                        rope_tables=rope)
    with L.scope("nugget_block_attn.attend"):
        ctx = A.attend(cfg.attention_impl, q, k, v, positions, positions,
                       dims.layout, causal=True, window=window,
                       cap=cfg.attn.softcap, q_chunk=cfg.attn_chunk,
                       kv_chunk=cfg.attn_chunk,
                       causal_skip=cfg.attn_causal_skip)
    with L.scope("nugget_block_attn.out"):
        y = A.out_proj(p["attn"], dims.layout, ctx, dt)
    return y, (k, v)


def _attn_block(p, cfg: ArchConfig, dims: ModelDims, x, positions, window,
                *, plus_one: bool, aux: Dict, rope=None):
    # the block's label: a profile locates its ops by it (paper §III-D2)
    with L.scope("nugget_block_attn"):
        y, kv = _attn_out(p, cfg, dims, x, positions, window,
                          plus_one=plus_one, rope=rope)
        return x + y, kv


def _ffn(p, cfg, h, *, aux: Dict, rng=None):
    """The layer's MLP, or its MoE, whose aux entries are added into
    ``aux`` (``aux[key] = aux.get(key, 0) + val``, as the reference)."""
    if "moe" not in p:
        return L.mlp(p["mlp"], h, cfg.act, h.dtype)
    y, moe_aux = M.moe_mlp(p["moe"], cfg, h, rng=rng)
    for key, val in moe_aux.items():
        aux[key] = aux.get(key, 0) + val
    return y


def _mlp_block(p, cfg, x, *, plus_one: bool, aux: Dict, rng=None):
    with L.scope("nugget_block_moe" if "moe" in p else "nugget_block_mlp"):
        h = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps, plus_one=plus_one)
        y = _ffn(p, cfg, h, aux=aux, rng=rng)
        if "moe" not in p:
            y = shard(y, "batch", "seq", "act_embed")
        return x + y


def dense_layer(p, cfg, dims, x, positions, window, *, plus_one=False,
                aux=None, rope=None, rng=None):
    aux = {} if aux is None else aux
    if cfg.parallel_block:
        # PaLM-style parallel residual: y = x + attn(n1(x)) + mlp(n2(x))
        attn_out, kv = _attn_out(p, cfg, dims, x, positions, window,
                                 plus_one=plus_one, rope=rope)
        h2 = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps, plus_one=plus_one)
        y = _ffn(p, cfg, h2, aux=aux, rng=rng)
        x = x + (attn_out + y)
        return shard(x, "batch", "seq", "act_embed"), kv, aux
    x, kv = _attn_block(p, cfg, dims, x, positions, window,
                        plus_one=plus_one, aux=aux, rope=rope)
    x = _mlp_block(p, cfg, x, plus_one=plus_one, aux=aux, rng=rng)
    return x, kv, aux


def ssm_layer(p, cfg, x, *, aux=None):
    aux = {} if aux is None else aux
    with L.scope("nugget_block_mamba"):
        h = L.rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
        return x + S.mamba2_block(p["ssm"], cfg, h), aux


# ---------------------------------------------------------------------------
# Full-sequence forward (training / prefill)
# ---------------------------------------------------------------------------


def _aux_zero(cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    """The aux entries at zero that each layer's are added to."""
    if cfg.family != "moe":
        return {}
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return {"router_aux_loss": torch.zeros((), **f32),
            "router_logits_max": torch.zeros((), **f32),
            "expert_tokens": torch.zeros((cfg.moe.n_experts,), **i32),
            "dropped_tokens": torch.zeros((), **i32)}


def decoder_stack(params, cfg: ArchConfig, dims: ModelDims, x, positions,
                  *, collect_kv: bool = False, rng=None, plus_one=False):
    """Run all layers full-sequence.  Returns (x, aux, kv or None); kv is a
    pair of per-layer (hybrid: per-group) lists of [B,S,KVp,hd] tensors.
    ``rng``: the router jitter's generator (MoE with ``router_jitter > 0``;
    each layer draws from its own, derived from it)."""
    require_ported(cfg)
    layers = split_layers(params, cfg)
    if cfg.family == "ssm":
        body = _maybe_remat(lambda xc, p: ssm_layer(p, cfg, xc)[0], cfg)
        for p in layers:
            x = body(x, p)
        return x, {}, None
    if cfg.family == "hybrid":
        return _hybrid_stack(params, layers, cfg, dims, x, positions,
                             collect_kv=collect_kv)
    windows = cfg.layer_windows()
    rope = rope_tables(cfg, positions)           # once for all layers
    g = cfg.remat_group
    if not (cfg.scan_layers and g > 1 and cfg.n_layers % g == 0
            and not collect_kv):
        g = 1

    jitter = rng if cfg.moe is not None and cfg.moe.router_jitter > 0 \
        else None

    def body(xc, lo: int):
        # remat GROUPS of g layers: the backward stash holds one residual
        # per group instead of one per layer.  The group's aux is an output
        # of the body: a rematerialised forward recomputes it in the
        # backward and drops it, so nothing is counted twice.
        kvs, aux_g = [], {}
        for i in range(lo, lo + g):
            xc, kv, aux_g = dense_layer(
                layers[i], cfg, dims, xc, positions, windows[i],
                plus_one=plus_one, aux=aux_g, rope=rope,
                rng=M.layer_generator(jitter, i))
            if collect_kv:
                kvs.append(kv)
        return xc, kvs, aux_g

    body = _maybe_remat(body, cfg)
    ks, vs = [], []
    aux = _aux_zero(cfg, x.device)
    for lo in range(0, cfg.n_layers, g):
        x, kvs, aux_g = body(x, lo)
        for key, val in aux_g.items():
            aux[key] = aux[key] + val
        ks += [k for k, _ in kvs]
        vs += [v for _, v in kvs]
    return x, aux, ((ks, vs) if collect_kv else None)


def _hybrid_groups(cfg: ArchConfig):
    ae = max(cfg.attn_every, 1)
    n_groups = cfg.n_layers // ae
    remainder = cfg.n_layers - n_groups * ae
    return ae, n_groups, remainder


def _shared_attn_block(params, cfg, dims, x, positions, *, collect_kv=False,
                       rope=None):
    """The hybrid's shared attention + MLP block over the sequence.  (The
    decode step writes the new token's k/v into the cache between the
    projection and the attention, so it runs these steps itself, as the
    reference's `lm_decode` does.)"""
    p = params["shared_attn"]
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    dt = x.dtype
    q, k, v = A.qkv(p["attn"], cfg.attn, dims.layout, h, positions, dt,
                    rope_tables=rope)
    ctx = A.attend(cfg.attention_impl, q, k, v, positions, positions,
                   dims.layout, causal=True, window=-1,
                   q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    x = x + A.out_proj(p["attn"], dims.layout, ctx, dt)
    h = L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    x = x + shard(L.mlp(p["mlp"], h, cfg.act, dt), "batch", "seq", "act_embed")
    return x, (k, v) if collect_kv else None


def _hybrid_stack(params, layers, cfg, dims, x, positions, *,
                  collect_kv=False):
    """Groups of ``attn_every`` Mamba2 layers (each rematerialised under
    grad, as the reference's ``ssm_body``), the shared block after each."""
    ae, n_groups, _ = _hybrid_groups(cfg)
    rope = rope_tables(cfg, positions)           # once for all groups
    ssm_body = _maybe_remat(lambda xc, p: ssm_layer(p, cfg, xc)[0], cfg)
    ks, vs = [], []
    for g in range(n_groups):
        for p in layers[g * ae:(g + 1) * ae]:
            x = ssm_body(x, p)
        x, kv = _shared_attn_block(params, cfg, dims, x, positions,
                                   collect_kv=collect_kv, rope=rope)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    for p in layers[n_groups * ae:]:
        x = ssm_body(x, p)
    return x, {}, ((ks, vs) if collect_kv else None)


# ---------------------------------------------------------------------------
# Top-level model
# ---------------------------------------------------------------------------


def embed_tokens(params, cfg: ArchConfig, dims: ModelDims, tokens,
                 patch_embeds=None):
    """Token embeddings; for the VLM, ``patch_embeds`` [B, n_patches,
    d_model] projected by ``patch_proj`` take the first ``n_patches``
    positions (all of them when the prompt is shorter)."""
    dt = dtype_of(cfg.compute_dtype)
    x = L.embed_lookup(params["embed"], tokens, dt)
    if cfg.name.startswith("gemma"):
        # the factor is rounded to the compute dtype first, as the reference
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    if cfg.n_patches and patch_embeds is not None:
        pe = L.dense(params["patch_proj"], patch_embeds.to(dt), dt)
        x = (torch.cat([pe, x[:, cfg.n_patches:]], dim=1)
             if x.shape[1] > cfg.n_patches else pe[:, :x.shape[1]])
    return shard(x, "batch", "seq", "act_embed")


def unembed(params, cfg: ArchConfig, dims: ModelDims, x):
    dt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x, dt)
    else:
        logits = L.dense(params["lm_head"], x, dt)
    logits = shard(logits, "batch", "seq", "act_vocab")
    if dims.vocab_pad > cfg.vocab_size:
        mask = torch.arange(dims.vocab_pad, device=x.device) < cfg.vocab_size
        logits = torch.where(mask[None, None], logits, -1e30)
    return logits


def positions_for(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


def lm_forward(params, cfg: ArchConfig, dims: ModelDims, tokens, *,
               patch_embeds=None, rng=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits, aux)."""
    plus_one = cfg.name.startswith("gemma")
    positions = positions_for(tokens)
    x = embed_tokens(params, cfg, dims, tokens, patch_embeds)
    x, aux, _ = decoder_stack(params, cfg, dims, x, positions, rng=rng,
                              plus_one=plus_one)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, plus_one=plus_one)
    return unembed(params, cfg, dims, x), aux
