# Counterpart of src/repro/launch/dryrun.py: the same cells, CLI, knobs and
# result keys.  Where the reference lowers and compiles a cell's step on 512
# forced host devices, the port does three things, none of which allocates:
#   - bytes per device by shape arithmetic, from the plan's placements on the
#     production mesh's shape and the meta-tensor trees (`input_specs`,
#     `cache_specs_struct`, the train state), with no process group;
#   - `trace_*_global` from `trace_cost` of the step at global shapes on meta
#     tensors, with no plan, as the reference's jaxpr walk (a train step is
#     priced part by part: `TrainStep.start`, `microbatch` times
#     `accumulate`, `finish`; the sum equals the unrolled step's trace);
#   - `flops`, `bytes_accessed`, `collectives` and `op_histogram_top` from the
#     per-rank program that DTensor dispatches on fake tensors, as rank 0 of
#     a fake process group of the production mesh's 256 or 512 ranks
#     (`launch/mesh.make_fake_mesh`, recorded by
#     `core/hlo_analysis.ProgramRecorder`; per rank, as the reference's
#     `cost_analysis` is per partition).
# The impls are "chunked", the reference config's default and what its
# dry-run traces (the port's "cuda" would reach a kernel wrapper).  A train
# cell whose rank owns fewer rows than `microbatch` is traced at the largest
# `microbatch_traced` that divides them; `microbatch` (the table's) is what
# the roofline reads.  `remat="full"`: the reference's walker recurses into
# the `checkpoint` equation of the backward, so it counts the recomputed
# forward; the port's backward trace holds the recompute too (equal matmul
# FLOPs, tests/test_torch_dryrun_trace.py), and with `--remat selective` only
# the recomputed batched products (tests/test_torch_remat_trace.py).  With
# `--weight-quant int4` a payload is stored packed, two values a byte
# (`layers.stored_shape`): the reference's 0.5 B a value.  A train cell with
# int8 or int4 weights errs in both packages: a train step differentiates
# every parameter, and an integer payload has no gradient.
# The `mem_*` of the reference's `memory_analysis` come from the per-rank
# program too (`hlo_analysis.LiveBytes`: each storage it creates, from the
# creating call to the release of its last reference; a train cell's parts
# run in sequence under one tracker), and `hlo_bytes` is the length of its
# text (`hlo_analysis.program_text`, each part once).  `--dump-hlo` is
# accepted and, as in the reference, read by nothing.
# Fields of the reference's dict with no counterpart, because the port
# compiles nothing: `compile_s` and `mem_generated_code_size_in_bytes`; and
# the `cost_analysis` entries other than "flops" and "bytes accessed".
# Added: the impls, `microbatch_traced`, `trace_s` and `program_s` (the
# global trace's and the per-rank program's seconds) and `kernel_launches`.
"""Dry-run: price every (arch × shape × mesh) cell's step on fake tensors
with no allocation on the production meshes, and record bytes per device,
FLOPs and collectives for the roofline.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
        --mesh single [--device cpu]
    python -m repro_torch.launch.dryrun --all   # every cell, process-per-cell
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Union

import torch

# activation-memory-driven gradient-accumulation factors (global batch 256)
MICROBATCH = {
    "mistral-large-123b": 64,
    "internvl2-76b": 64,
    "llama4-scout-17b-a16e": 16,
    "qwen2.5-14b": 16,
    "gemma3-4b": 8,
    "qwen3-1.7b": 4,
    "mamba2-780m": 8,
    "zamba2-1.2b": 8,
    "olmoe-1b-7b": 4,
    "whisper-tiny": 1,
}

IMPLS = dict(attention_impl="chunked", ssm_impl="chunked")
DEFAULT_OUT = "artifacts/dryrun_torch"


def cell_id(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


# ---------------------------------------------------------------------------
# bytes per device: shape arithmetic over a plan's placements
# ---------------------------------------------------------------------------


def _shard_shape(shape, sharding):
    """The local shape of a leaf of global ``shape`` under ``sharding``, a
    ``(mesh, placements)`` pair (None: replicated); an uneven split raises,
    as the reference's partitioner does."""
    if sharding is None:
        return tuple(shape)
    from repro_torch.distributed.sharding import check_even, mesh_axes
    mesh, pl = sharding
    check_even("leaf", shape, mesh, pl)
    out = list(shape)
    for size, p in zip(mesh_axes(mesh).values(), pl):
        if hasattr(p, "dim"):
            out[p.dim] //= size
    return tuple(out)


def _pairs(tree, shardings):
    """(leaf, sharding) of two trees of one structure (dicts, NamedTuples,
    lists); a sharding is a ``(mesh, placements)`` pair or None."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, shardings[k])
    elif hasattr(tree, "_fields"):
        for v, s in zip(tree, shardings):
            yield from _pairs(v, s)
    elif tree is not None:
        yield tree, shardings


def _tree_bytes_per_device(struct_tree, shardings) -> int:
    """Bytes of one device's shards (an int4 payload is stored packed, two
    values a byte: the reference's 0.5 B a value)."""
    return sum(math.prod(_shard_shape(s.shape, sh)) * s.dtype.itemsize
               for s, sh in _pairs(struct_tree, shardings))


# ---------------------------------------------------------------------------
# trees on fake tensors
# ---------------------------------------------------------------------------


def _fake_dtensor(t: torch.Tensor, sharding, device):
    """A DTensor of ``t``'s global shape and dtype with an empty local
    tensor on ``device`` (fake inside `FakeTensorMode`)."""
    from torch.distributed.tensor import DTensor
    mesh, pl = sharding
    local = torch.empty(_shard_shape(t.shape, sharding), dtype=t.dtype,
                        device=device)
    full = torch.Size(t.shape)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=full,
                              stride=torch.empty(full, device="meta").stride())


def _fake_tree(tree, shardings, device):
    if isinstance(tree, dict):
        return {k: _fake_tree(v, shardings[k], device)
                for k, v in tree.items()}
    return _fake_dtensor(tree, shardings, device)


def _spec_struct(specs, param_dtype):
    from repro_torch.models import layers as L
    return L.map_specs(lambda s: torch.empty(
        L.stored_shape(s), dtype=L.spec_dtype(s) or param_dtype,
        device="meta"), specs)


def _batch_shardings(mesh, plan, batch):
    from repro_torch.distributed.sharding import placements
    axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
            "frames": ("batch", None, None), "patches": ("batch", None, None),
            "token": ("batch", None)}
    return {k: (mesh, placements(mesh, plan.spec(axes[k]))) for k in batch}


def _replicated(mesh):
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.sharding import mesh_axes
    return (mesh, (Replicate(),) * len(mesh_axes(mesh)))


def microbatch_for(arch: str, cfg, multi_pod: bool,
                   override: Optional[int] = None) -> int:
    """The reference's accumulation factor of a train cell."""
    mb = MICROBATCH.get(arch, 1)
    if multi_pod:
        mb = max(1, mb // 2)
    if cfg.remat_group > 1:
        mb = max(1, mb // cfg.remat_group)
    return override or mb


def microbatch_traced(rows_per_rank: int, microbatch: int) -> int:
    """The largest count <= ``microbatch`` that divides a rank's rows."""
    return max(m for m in range(1, min(microbatch, rows_per_rank) + 1)
               if rows_per_rank % m == 0)


def configure(arch: str, *, causal_skip: bool = False,
              remat: Optional[str] = None, attn_chunk: Optional[int] = None,
              parallel_block: bool = False, remat_group: int = 1,
              weight_quant: str = "none", cache_quant: str = "none",
              capacity_factor: Optional[float] = None):
    """The cell's config: the arch's, on the chunked impls, with the knobs
    applied as the reference applies them.  An architecture of the port
    alone has no cell: the dry-run prices the reference's cells."""
    from repro_torch.configs import PORT_ONLY, get_config
    if arch in PORT_ONLY:
        raise NotImplementedError(
            f"{arch}: no dry-run cell; the dry-run prices the JAX package's "
            f"architectures on its meshes and plans, and this one is the "
            f"port's alone ({PORT_ONLY[arch]})")
    cfg = dataclasses.replace(get_config(arch), **IMPLS)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if attn_chunk:
        cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk)
    if causal_skip:
        cfg = dataclasses.replace(cfg, attn_causal_skip=True)
    if parallel_block:
        cfg = dataclasses.replace(cfg, parallel_block=True)
    if remat_group > 1:
        cfg = dataclasses.replace(cfg, remat_group=remat_group)
    if weight_quant != "none":
        cfg = dataclasses.replace(cfg, weight_quant=weight_quant)
    if cache_quant != "none":
        cfg = dataclasses.replace(cfg, cache_quant=cache_quant)
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Layout:
    """What a cell's plan and shapes give before anything is traced: the
    result's plan fields and bytes per device, and the meta trees."""
    result: Dict[str, Any]
    cfg: Any
    shape: Any
    model: Any                      # built on the meta device, under the plan
    params: Any                     # meta trees
    batch: Dict[str, torch.Tensor]
    cache: Optional[Dict[str, torch.Tensor]] = None
    state: Any = None
    table: Any = None
    opt_cfg: Any = None


def layout_cell(arch: str, shape: Union[str, Any], mesh_kind: str, *,
                mesh=None, instrument: bool = True,
                microbatch_override: Optional[int] = None,
                extra_tag: str = "", **knobs) -> Union[Layout, Dict]:
    """The plan and the bytes per device of one cell, by shape arithmetic
    on ``mesh`` (default: the production mesh's shape; no process group).
    A skipped cell gives its result dict."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import dtype_of
    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.distributed.sharding import (mesh_axes,
                                                  params_shardings, plan_for,
                                                  placements)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import kvcache as KC
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig, OptState
    from repro_torch.train.state import TrainState, init_train_state

    shape = SHAPES[shape] if isinstance(shape, str) else shape
    multi_pod = mesh_kind == "multi"
    cfg = configure(arch, **knobs)
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return {"cell": cell_id(arch, shape.name, mesh_kind),
                "status": "skipped(full-attention)",
                "note": "long_500k requires sub-quadratic attention "
                        "(DESIGN.md §Arch-applicability)"}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_axes(mesh)
    n_dev = math.prod(sizes.values())

    mode = "train" if shape.kind == "train" else "serve"
    bytes_per_param = {"int8": 1.0, "int4": 0.5}.get(cfg.weight_quant, 2.0)
    # plan_for decides serve-FSDP from bf16 bytes; feed it the effective
    # byte count so quantized weights can stay TP-only (no per-token
    # weight gathers)
    plan = plan_for(mesh, arch, mode, shape.name,
                    int(cfg.param_count() * bytes_per_param / 2))
    model = build_model(cfg, plan, device="meta")

    dp = math.prod(sizes[a] for a in plan.dp_axes) if plan.dp_axes else 1
    # effective devices doing distinct compute (roofline denominator):
    # whisper replicates over "model"; mamba2 long-context leaves "data" idle
    eff = dp * plan.tp_size
    if shape.name == "long_500k":
        data_sz = int(sizes.get("data", 1))
        eff = plan.tp_size * (data_sz if cfg.family != "ssm" else 1)
    result: Dict[str, Any] = {
        "cell": cell_id(arch, shape.name, mesh_kind) + extra_tag,
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "devices": n_dev, "kind": shape.kind,
        "tp": plan.tp_size,
        "dp": dp,
        "eff_devices": eff,
        "fsdp": plan.lookup("embed") is not None,
        "family": cfg.family,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "tokens": shape.tokens,
        "weight_quant": cfg.weight_quant,
        "cache_quant": cfg.cache_quant,
        "parallel_block": cfg.parallel_block,
        "remat_group": cfg.remat_group,
        "tp_ar_per_layer": 1 if cfg.parallel_block else 2,
        "grad_rs_bytes": 2.0 if cfg.param_dtype == "bfloat16" else 4.0,
        "bytes_per_param": bytes_per_param,
        "attention_impl": cfg.attention_impl, "ssm_impl": cfg.ssm_impl,
        "status": "running",
    }
    p_shard = params_shardings(mesh, plan, model.axes())
    params = _spec_struct(model.specs(), dtype_of(cfg.param_dtype))
    lay = Layout(result, cfg, shape, model, params, model.input_specs(shape))
    if shape.kind == "train":
        mb = microbatch_for(arch, cfg, multi_pod, microbatch_override)
        result["microbatch"] = mb
        result["microbatch_traced"] = microbatch_traced(
            shape.global_batch // dp, mb)
        lay.table = build_block_table(model, shape) if instrument else None
        lay.opt_cfg = AdamWConfig()
        lay.state = init_train_state(model, params, lay.opt_cfg, lay.table)
        rep = _replicated(mesh)
        meter = (None if lay.state.meter is None else
                 {k: rep for k in lay.state.meter})
        result["state_bytes_per_device"] = _tree_bytes_per_device(
            lay.state, TrainState(rep, p_shard,
                                  OptState(rep, p_shard, p_shard, p_shard),
                                  rep, meter))
    else:
        lay.cache = model.cache_specs_struct(shape)
        c_shard = {k: (mesh, placements(mesh, spec))
                   for k, spec in KC.cache_specs(lay.cache, plan).items()}
        result["params_bytes_per_device"] = _tree_bytes_per_device(
            params, p_shard)
        result["cache_bytes_per_device"] = _tree_bytes_per_device(
            lay.cache, c_shard)
    return lay


def _train_parts(step, state, batch, microbatch: int, run):
    """The train step part by part: ``run(fn, args, reps)`` runs each part
    and returns its outputs (the next part's arguments); ``accumulate``
    stands for ``microbatch`` slices (``reps``).  Returns the step's
    outputs (``finish``'s)."""
    if microbatch == 1:
        loss, aux, grads = run(step.grads_of, (state.params, batch, None), 1)
    else:
        slices, acc = run(step.start, (state, batch), 1)
        grads, loss, aux = run(step.accumulate,
                               (state, slices[0], None, acc), microbatch)
    return run(step.finish, (state, list(grads), loss, aux), 1)


def recorded_cost(fn, *args):
    """(cost, outputs) of ``fn`` run once on ``args`` under a
    `ProgramRecorder`: on meta tensors, the ATen calls that `trace_cost`'s
    graph holds, at a fifth of make_fx's time, and the outputs with them
    (tests/test_torch_dryrun_trace.py holds the two costs equal)."""
    from repro_torch.core.hlo_analysis import ProgramRecorder
    from repro_torch.core.unit_of_work import graph_cost
    rec = ProgramRecorder()
    with torch.no_grad(), rec:
        out = fn(*args)
    return graph_cost(rec.ops), out


def _global_cost(lay: Layout, instrument: bool):
    """The step's cost at global shapes on meta tensors, no plan active
    (the reference's `trace_cost`, its global view)."""
    from repro_torch.core.unit_of_work import IRCost
    from repro_torch.optim.schedule import constant
    from repro_torch.train.state import make_train_step
    model = lay.model
    if lay.shape.kind == "prefill":
        return recorded_cost(model.prefill, lay.params, lay.batch,
                             lay.cache)[0]
    if lay.shape.kind == "decode":
        return recorded_cost(model.decode_step, lay.params,
                             lay.batch["token"], lay.cache)[0]
    mb = lay.result["microbatch"]
    step = make_train_step(model, lay.opt_cfg, constant(1e-4),
                           table=lay.table, microbatch=mb,
                           instrument=instrument)
    total = [IRCost(0.0, 0.0, 0)]

    def run(fn, args, reps):
        cost, out = recorded_cost(fn, *args)
        total[0] = total[0] + cost.scale(reps)
        return out
    _train_parts(step, lay.state, lay.batch, mb, run)
    return total[0]


def _record_program(lay: Layout, mesh, device, instrument: bool):
    """([(recorded ops, reps)], its ``mem_*`` fields) of the per-rank
    program of the cell's step, run as rank ``mesh``'s own on fake tensors
    under its plan.  The arguments are the parameters, the cache or the
    train state, and the batch; a train cell's parts run in sequence under
    one `LiveBytes`, so that what one part leaves to the next counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.core.hlo_analysis import ProgramRecorder
    from repro_torch.distributed.sharding import (params_shardings, plan_for,
                                                  placements, sharded_region,
                                                  use_rules)
    from repro_torch.models import kvcache as KC
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.schedule import constant
    from repro_torch.train.state import init_train_state, make_train_step
    res, shape = lay.result, lay.shape
    mode = "train" if shape.kind == "train" else "serve"
    plan = plan_for(mesh, res["arch"], mode, shape.name,
                    int(res["param_count"] * res["bytes_per_param"] / 2))
    rec = ProgramRecorder()
    parts = []
    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(plan):
        model = build_model(lay.cfg, plan, device=device)
        params = _fake_tree(lay.params, params_shardings(
            mesh, plan, model.axes()), device)
        batch = _fake_tree(lay.batch, _batch_shardings(mesh, plan,
                                                       lay.batch), device)
        if shape.kind == "train":
            table = build_block_table(model, shape) if instrument else None
            state = init_train_state(model, params, lay.opt_cfg, table)
            mb = res["microbatch_traced"]
            step = make_train_step(model, lay.opt_cfg, constant(1e-4),
                                   table=table, microbatch=mb,
                                   instrument=instrument)

            def run(fn, args, reps):
                n = len(rec.ops)
                with rec:
                    out = fn(*args)
                parts.append((rec.ops[n:], reps))
                return out
            rec.memory.add_arguments((state, batch))
            with sharded_region(params):
                out = _train_parts(step, state, batch, mb, run)
            return parts, rec.memory.summary(out)
        specs = KC.cache_specs(lay.cache, plan)
        cache = {k: _fake_dtensor(v, (mesh, placements(mesh, specs[k])),
                                  device) for k, v in lay.cache.items()}
        rec.memory.add_arguments((params, batch, cache))
        with rec, sharded_region(params):
            if shape.kind == "prefill":
                out = model.prefill(params, batch, cache)
            else:
                out = model.decode_step(params, batch["token"], cache)
        return [(rec.ops, 1)], rec.memory.summary(out)


def run_cell(arch: str, shape: Union[str, Any], mesh_kind: str,
             *, mesh=None, device=None, instrument: bool = True,
             microbatch_override: Optional[int] = None,
             extra_tag: str = "", **knobs) -> Dict[str, Any]:
    """Price one cell.  ``shape``: a name of `SHAPES` or a `ShapeConfig`.
    ``mesh``: the DeviceMesh whose rank 0 the per-rank program is recorded
    as (default: a fake one of ``mesh_kind``'s production shape, made here;
    it takes this process's process group for good).  ``knobs``: those of
    `configure`."""
    from repro_torch.core import hlo_analysis as H
    from repro_torch.core.unit_of_work import IRCost, graph_cost
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_fake_mesh

    t_start = time.time()
    dev = resolve_device(device)
    lay = layout_cell(arch, shape, mesh_kind, mesh=mesh,
                      instrument=instrument,
                      microbatch_override=microbatch_override,
                      extra_tag=extra_tag, **knobs)
    if isinstance(lay, dict):
        return lay
    result = lay.result
    result["device"] = dev.type
    t0 = time.time()
    tc = _global_cost(lay, instrument)
    result["trace_s"] = time.time() - t0
    result["trace_flops_global"] = tc.flops
    result["trace_bytes_global"] = tc.bytes
    result["trace_ops_global"] = tc.ops

    if mesh is None:
        mesh = make_fake_mesh(multi_pod=mesh_kind == "multi", device=dev)
    t0 = time.time()
    parts, memory = _record_program(lay, mesh, dev, instrument)
    result["program_s"] = time.time() - t0
    result["lower_s"] = time.time() - t_start

    pc = IRCost(0.0, 0.0, 0)
    coll = {k: {"count": 0, "bytes": 0.0} for k in H.COLLECTIVES}
    hist: Dict[str, int] = {}
    for ops, reps in parts:
        pc = pc + graph_cost(ops).scale(reps)
        for k, v in H.collective_stats(ops).items():
            coll[k]["count"] += v["count"] * reps
            coll[k]["bytes"] += v["bytes"] * reps
        for k, n in H.op_histogram(ops).items():
            hist[k] = hist.get(k, 0) + n * reps
    result["cost_analysis"] = {"flops": pc.flops, "bytes accessed": pc.bytes}
    result["flops"] = pc.flops
    result["bytes_accessed"] = pc.bytes
    result["collectives"] = coll
    result["collective_bytes"] = sum(v["bytes"] for v in coll.values())
    result["op_histogram_top"] = dict(
        sorted(hist.items(), key=lambda kv: -kv[1])[:20])
    result.update(memory)
    result["hlo_bytes"] = sum(len(H.program_text(ops).encode())
                              for ops, _ in parts)
    result["kernel_launches"] = kernel_launches()
    result["status"] = "ok"
    result["total_s"] = time.time() - t_start
    return result


def kernel_launches() -> Dict[str, int]:
    """The K1 / K2 / K3, grouped MoE and latent-decode wrappers' launch
    counts in this process (a dry-run cell runs on fake tensors and launches
    none)."""
    from repro_torch.kernels import build
    return build.launches()


# ---------------------------------------------------------------------------


def all_cells():
    """Every (arch, shape, mesh) cell of the architectures that the JAX
    package has too (`configure` names the port's own as skipped)."""
    from repro_torch.configs import SHAPES, reference_archs
    for arch in reference_archs():
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                yield arch, shape, mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-instrument", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--remat")
    ap.add_argument("--attn-chunk", type=int)
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--parallel-block", action="store_true")
    ap.add_argument("--remat-group", type=int, default=1)
    ap.add_argument("--weight-quant", default="none")
    ap.add_argument("--cache-quant", default="none")
    ap.add_argument("--capacity-factor", type=float)
    ap.add_argument("--microbatch", type=int)
    ap.add_argument("--dump-hlo", action="store_true",
                    help="accepted as the reference's; read by nothing")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default=None,
                    help="cpu for fake CPU tensors (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    resolve_device(args.device)         # no card and no --device cpu: raise
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cmds = {}
        for arch, shape, mesh in all_cells():
            path = os.path.join(args.out, cell_id(arch, shape, mesh) + ".json")
            if args.skip_existing and os.path.exists(path):
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", args.out]
            if args.no_instrument:
                cmd.append("--no-instrument")
            if args.device:
                cmd += ["--device", args.device]
            cmds[cell_id(arch, shape, mesh)] = cmd

        def one(cell):
            print(f"=== {cell}", flush=True)
            return subprocess.call(cmds[cell])
        # one process per cell (each holds a fake process group), one a
        # core at a time (a cell is one thread of host work, 0.4-0.6 GB)
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            rcs = dict(zip(cmds, pool.map(one, cmds)))
        failures = [c for c, rc in rcs.items() if rc != 0]
        print("failures:", failures)
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    path = os.path.join(args.out, cell_id(args.arch, args.shape, args.mesh)
                        + args.tag + ".json")
    try:
        res = run_cell(args.arch, args.shape, args.mesh, device=args.device,
                       instrument=not args.no_instrument,
                       remat=args.remat, attn_chunk=args.attn_chunk,
                       causal_skip=args.causal_skip,
                       parallel_block=args.parallel_block,
                       remat_group=args.remat_group,
                       weight_quant=args.weight_quant,
                       cache_quant=args.cache_quant,
                       capacity_factor=args.capacity_factor,
                       microbatch_override=args.microbatch,
                       extra_tag=args.tag)
    except Exception:
        res = {"cell": cell_id(args.arch, args.shape, args.mesh) + args.tag,
               "status": "error", "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    ok = res["status"].startswith(("ok", "skipped"))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("op_histogram_top", "traceback")}, indent=1))
    if not ok:
        print(res.get("traceback", ""), file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
