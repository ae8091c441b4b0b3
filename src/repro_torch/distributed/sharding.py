# Counterpart of src/repro/distributed/sharding.py; nothing of it is left
# unported.  The plan carries its `DeviceMesh` in a `mesh` field (None for the
# shape-only meshes of `launch/mesh.make_production_mesh`, on which a plan is
# priced but never run).  `with_sharding_constraint` becomes
# `DTensor.redistribute`; a `PartitionSpec` becomes a plain tuple with one
# entry per tensor dim (None, a mesh axis name or a tuple of names), and
# `placements` turns it into DTensor placements.  Where the reference leaves
# a jitted step to the SPMD partitioner, the port runs DTensor's eager
# sharding propagation; the tensors the model makes itself (positions, rope
# tables, masks, `arange`s, the running sums of the chunked attention) stay
# plain tensors and the sharded step runs under DTensor's
# `implicit_replication` (`sharded_region`), which treats them as replicated.
# They are replicated by construction: every rank makes the same values from
# global shapes.  Turning each into a DTensor where it is made would touch
# every such site in the model for the same result.  The flag is part of the
# thread-local state that autograd hands to its backward threads, so the
# rematerialised forward and the backward of a layer see it too.  Where
# DTensor has no strategy for an op (`searchsorted`), or a torch version
# refuses one (2.11 cannot fold a batch sharded over two mesh dims into a
# batched product, nor place the embedding's `index_put` backward), the work
# runs on each rank's own part as plain tensors (`local_part`,
# `lookup_rows`): the attention core per (row, head), the embedding lookup
# and the CE per row, the MoE routing and dispatch per row, the SSD and the
# decode step's state update per (row, head), the cache writes.  At the
# production mesh's 16 ranks DTensor's strategy search also fails for weight
# products, so those run with placements fixed here (`fsdp_gather`,
# `sharded_product`).
"""Logical-axis → mesh-axis sharding rules.

Model code annotates params and activations with *logical* axis names; the
active :class:`ShardingPlan` maps those to mesh axes.  Rules differ between
training (2D FSDP×TP) and serving (TP + batch- or sequence-sharded KV), and
per-arch overrides can disable tensor parallelism for tiny models (whisper).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

Spec = Tuple[Any, ...]        # one entry per tensor dim: None, a name, a tuple


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order, of a ``DeviceMesh`` or of a
    shape-only mesh (``axis_names`` and a ``shape`` mapping, as a JAX
    ``Mesh`` has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved mapping from logical axes to mesh axes."""
    rules: Tuple[Tuple[str, Any], ...]     # logical -> mesh axis (or tuple / None)
    tp_size: int                           # size of the tensor axis (1 = TP off)
    dp_axes: Tuple[str, ...]               # batch/FSDP mesh axes
    tp_axis: Optional[str]                 # tensor mesh axis name
    # the DeviceMesh that `shard` redistributes onto (None: shape only)
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def lookup(self, logical: Optional[str]):
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        resolved, used = [], set()
        for a in axes:
            v = self.lookup(a)
            # a mesh axis may appear at most once in a PartitionSpec
            flat = v if isinstance(v, tuple) else ((v,) if v else ())
            if any(m in used for m in flat):
                v = None
            else:
                used.update(flat)
            resolved.append(v)
        return tuple(resolved)


def _mk(rules: Dict[str, Any], tp_size: int, dp_axes, tp_axis,
        mesh) -> ShardingPlan:
    device_mesh = mesh if hasattr(mesh, "mesh_dim_names") else None
    return ShardingPlan(tuple(rules.items()), tp_size, tuple(dp_axes),
                        tp_axis, device_mesh)


def logical_rules(mesh, *, mode: str = "train",
                  tp_enabled: bool = True,
                  shard_seq: bool = False) -> ShardingPlan:
    """Build the sharding plan for a mesh.

    mode="train":  batch over (pod?,data); params 2D: FSDP("data") × TP("model").
    mode="serve":  params TP only (replicated over data); batch over (pod?,data)
                   unless ``shard_seq`` (long-context) — then KV seq over "data".
    """
    sizes = mesh_axes(mesh)
    names = tuple(sizes)
    pod = "pod" if "pod" in names else None
    data = "data" if "data" in names else None
    model = "model" if "model" in names else None
    if not tp_enabled:
        model = None
    batch_axes = tuple(a for a in (pod, data) if a)
    if shard_seq:
        # long-context decode: batch=1 — the "data" axis shards the KV
        # sequence instead of the batch
        batch_axes = ()
    batch = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    fsdp = data if mode in ("train", "serve_fsdp") and not shard_seq else None
    tp_size = sizes["model"] if (model and "model" in names) else 1

    rules: Dict[str, Any] = {
        "batch": batch,
        "embed": fsdp,
        "mlp": model,
        "heads": model,
        "kv_heads": model,
        "head_dim": None,
        "vocab": model,
        "layer": None,
        "experts": model,
        "expert_mlp": None,
        "ssm_inner": model,
        "ssm_state": None,
        "conv": None,
        "act_embed": None,        # activation d_model dim
        "act_heads": model,       # activation head dim
        "act_vocab": model,       # logits vocab dim
        "kv_seq": ("data" if (shard_seq and data) else None),
        "seq": None,
    }
    return _mk(rules, tp_size, batch_axes, model, mesh)


# --------------------------------------------------------------------------
# Specs -> DTensor placements
# --------------------------------------------------------------------------


def placements(mesh, spec: Spec) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(tensor_dim)`` where a spec entry names it, else ``Replicate()``.
    A tuple entry (``("pod", "data")``) shards its tensor dim over those mesh
    dims, the first named splitting first, as DTensor splits in mesh order;
    a tuple in another order than the mesh's raises."""
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        flat = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in flat]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def check_even(name: str, shape, mesh, pl) -> None:
    """Raise, naming the leaf, where a sharded dim does not divide evenly
    over its mesh dims (DTensor would pad it; the reference's partitioner
    rejects such an input sharding)."""
    sizes = list(mesh_axes(mesh).values())
    ways: Dict[int, int] = {}
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * sizes[i]
    for dim, n in ways.items():
        if shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of shape {tuple(shape)} does "
                             f"not divide over {n} shards")


# --------------------------------------------------------------------------
# Active-plan context: model code calls shard(x, *logical_axes); it is a
# no-op unless a plan is active and x is a DTensor (tests / single-device
# runs).
# --------------------------------------------------------------------------

_STATE = threading.local()


def set_rules(plan: Optional[ShardingPlan]):
    _STATE.plan = plan


def active_rules() -> Optional[ShardingPlan]:
    return getattr(_STATE, "plan", None)


@contextlib.contextmanager
def use_rules(plan: Optional[ShardingPlan]):
    prev = active_rules()
    set_rules(plan)
    try:
        yield
    finally:
        set_rules(prev)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    plan = getattr(_STATE, "plan", None)
    if plan is None or not isinstance(x, DTensor):
        return x
    spec = plan.spec(axes)
    if all(s is None for s in spec):
        return x
    mesh = plan.mesh if plan.mesh is not None else x.device_mesh
    return x.redistribute(mesh, placements(mesh, spec))


def spec_for(axes: Sequence[Optional[str]]) -> Spec:
    plan = active_rules()
    if plan is None:
        return ()
    return plan.spec(axes)


def plan_for(mesh, arch_name: str, mode: str, shape_name: str = "",
             param_count: int = 0) -> ShardingPlan:
    """Per-arch overrides:

    - tiny models (whisper) skip TP entirely — replicating a 39 M-param model
      beats paying collectives for 24-wide matmuls;
    - long_500k shards the KV sequence over "data" (batch=1);
    - big-arch serving turns on FSDP-style weight sharding over "data" when
      bf16 params / tp_size exceed 8e9 bytes.  That threshold is the
      reference's rule, kept as it is so that both packages choose the same
      plan (it was set for a TPU's memory, not for the H100's 80 GB).
    """
    tp_enabled = arch_name not in ("whisper-tiny",)
    shard_seq = shape_name == "long_500k"
    tp = mesh_axes(mesh).get("model", 1) if tp_enabled else 1
    if mode == "serve" and param_count * 2 / max(tp, 1) > 8e9:
        mode = "serve_fsdp"
    return logical_rules(mesh, mode=mode, tp_enabled=tp_enabled,
                         shard_seq=shard_seq)


def params_shardings(mesh, plan: ShardingPlan, axes_tree) -> Any:
    """Map an axes tree (tuples of logical names) to ``(mesh, placements)``
    pairs, in the tree's key order."""
    if isinstance(axes_tree, dict):
        return {k: params_shardings(mesh, plan, v)
                for k, v in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):                      # NamedTuple
        return type(axes_tree)(*[params_shardings(mesh, plan, v)
                                 for v in axes_tree])
    return (mesh, placements(mesh, plan.spec(axes_tree)))


# --------------------------------------------------------------------------
# Putting trees onto a mesh
# --------------------------------------------------------------------------


def distribute(tree, shardings, prefix: str = ""):
    """Each tensor leaf of ``tree`` put onto its ``(mesh, placements)`` of
    ``shardings`` (the same structure) with ``distribute_tensor``: every rank
    gets rank 0's values.  Uneven sharding raises by leaf name.  A leaf
    keeps ``requires_grad``."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k], f"{prefix}/{k}")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[distribute(v, s, f"{prefix}/.{n}")
                            for n, v, s in zip(tree._fields, tree, shardings)])
    mesh, pl = shardings
    check_even(prefix or "leaf", tree.shape, mesh, pl)
    out = distribute_tensor(tree.detach(), mesh, pl)
    return out.requires_grad_(tree.requires_grad)


def distribute_batch(batch: Dict[str, torch.Tensor], plan: ShardingPlan
                     ) -> Dict[str, torch.Tensor]:
    """A batch's tensors (leading dims batch, sequence) put onto the plan's
    mesh, sharded over "batch" as the reference's step takes them."""
    pl = placements(plan.mesh, plan.spec(("batch", "seq")))
    return {k: distribute(v, (plan.mesh, pl), k) for k, v in batch.items()}


def process_group(group_or_mesh=None, axis: Optional[str] = None):
    """The process group of a DeviceMesh's dim ``axis`` (of a 1-D mesh, its
    only dim); a process group as it is (None: the world)."""
    if hasattr(group_or_mesh, "get_group"):
        return group_or_mesh.get_group(axis)
    return group_or_mesh


def to_plain(x):
    """A DTensor gathered to a full plain tensor on every rank (a
    collective: every rank must call it); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def any_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    return isinstance(tree, DTensor)


def sharded_region(tree):
    """``implicit_replication()`` when ``tree`` holds a DTensor (the plain
    tensors that the model makes count as replicated; see the head comment),
    else a null context."""
    return (implicit_replication() if any_dtensor(tree)
            else contextlib.nullcontext())


# --------------------------------------------------------------------------
# Shard-local work: ops without a DTensor sharding strategy
# --------------------------------------------------------------------------


def _kept(like: DTensor, dims, ndim: int, partial: bool = False):
    """``like``'s shards of the tensor dims ``dims`` (those below ``ndim``),
    every other mesh dim replicated; with ``partial``, the kept mesh dims
    become ``Partial()`` sums."""
    return tuple((Partial() if partial else Shard(p.dim))
                 if isinstance(p, Shard) and p.dim in dims and p.dim < ndim
                 else Replicate() for p in like.placements)


def local_part(t: torch.Tensor, like: torch.Tensor,
               dims: Sequence[int] = (0,)) -> torch.Tensor:
    """This rank's part of ``t`` along the shards that ``like`` (a DTensor)
    has of the tensor dims ``dims``, every other dim whole, as a plain
    tensor (differentiable).  A plain ``t`` counts as replicated.  ``t`` as
    it is where ``like`` is not a DTensor.  For work that is independent
    along those dims and has ops that DTensor cannot propagate
    (``searchsorted``, ``index_add_``, a ``gather`` over a sharded dim, the
    products of a sharded batch of heads)."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, _kept(like, dims, t.ndim)).to_local()


def from_local_part(t: torch.Tensor, like: torch.Tensor,
                    dims: Sequence[int] = (0,), *,
                    partial: bool = False) -> torch.Tensor:
    """Inverse of ``local_part``: ``t`` (this rank's part) as a DTensor
    sharded as ``like`` is along ``dims``, whose global sizes are
    ``like``'s; with ``partial``, ``t`` is this rank's share of a sum over
    all the parts (a count), whatever its shape.  ``t`` as it is where
    ``like`` is not a DTensor."""
    if not isinstance(like, DTensor):
        return t
    pl = _kept(like, dims, t.ndim if not partial else like.ndim, partial)
    shape = tuple(t.shape) if partial else tuple(
        like.shape[d] if d in dims else n for d, n in enumerate(t.shape))
    return DTensor.from_local(t, like.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def fsdp_gather(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered over every mesh dim but the active plan's
    tensor-parallel one, before it is used: the all-gather of 2-D FSDP
    (its gradient is the reduce-scatter).  Left to itself DTensor may pick
    a strategy for a product with a weight sharded over its contraction dim
    that shards the output where a later view cannot split it (at the
    production mesh's 16 ranks a layer's 8 kv heads).  Anything but a
    DTensor as it is."""
    if not isinstance(w, DTensor):
        return w
    plan = active_rules()
    tp = plan.tp_axis if plan is not None else None
    names = w.device_mesh.mesh_dim_names
    pl = tuple(p if names[i] == tp else Replicate()
               for i, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def sharded_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last dim and w's first (w may have more output
    dims: [din, h, hd]), with w a DTensor: a tensor-parallel product with the
    placements fixed here rather than left to DTensor's search.  Per mesh
    dim: w sharded on an output dim (column-parallel) takes x replicated and
    shards the output there; w sharded on its input dim (row-parallel) takes
    x sharded on its last dim and leaves a partial sum; a replicated w keeps
    x's shard of a leading (row) dim, anything else of x is gathered.  The
    product runs on the local tensors; each gradient comes back with the
    placement its rank's part has (a partial sum where ranks saw other rows,
    or other output columns).  Without this, DTensor's search can shard an
    output where a later view cannot split it, or fold a batch into a
    strided shard it cannot propagate."""
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    nx = x.ndim
    xp, yp, gx, gw = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(pw, Shard) and pw.dim > 0:          # column-parallel
            xp.append(Replicate())
            yp.append(Shard(nx - 2 + pw.dim))
            gx.append(Partial())
            gw.append(pw)
        elif isinstance(pw, Shard):                       # row-parallel
            xp.append(Shard(nx - 1))
            yp.append(Partial())
            gx.append(Shard(nx - 1))
            gw.append(pw)
        elif type(px) is Shard and px.dim < nx - 1:       # x's rows
            xp.append(px)
            yp.append(px)
            gx.append(px)
            gw.append(Partial())
        else:
            xp.append(Replicate())
            yp.append(Replicate())
            gx.append(Replicate())
            gw.append(Replicate())
    xl = x.redistribute(mesh, xp).to_local(grad_placements=gx)
    wl = w.to_local(grad_placements=gw)
    yl = (xl.reshape(-1, xl.shape[-1]) @ wl.reshape(wl.shape[0], -1)
          ).reshape(*xl.shape[:-1], *wl.shape[1:])
    shape = torch.Size((*x.shape[:-1], *w.shape[1:]))
    return DTensor.from_local(yl, mesh, yp, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def local_range(t: DTensor, dim: int) -> Tuple[int, int]:
    """(first global index, count) of this rank's part of ``t`` along
    ``dim``; the mesh dims that shard it split it in mesh order, evenly."""
    coord = t.device_mesh.get_coordinate()
    start, size = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= t.device_mesh.size(i)
            start += coord[i] * size
    return start, size


def lookup_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` where ``table`` or ``idx`` is a DTensor: the table
    gathered whole on every rank and indexed with this rank's rows of
    ``idx``, the result sharded over rows as ``idx`` is.  Each rank's
    gradient of the table comes from its own rows, so it is a partial sum
    over the mesh dims that split them.  (Indexing a DTensor table runs, but
    the backward's ``index_put`` has no strategy in every torch version.)"""
    like = idx if isinstance(idx, DTensor) else table
    mesh = like.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, rep, run_check=False)
    rows = _kept(idx, (0,), idx.ndim) if isinstance(idx, DTensor) else rep
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    out = table.redistribute(mesh, rep).to_local(grad_placements=grad)[
        local_part(idx, idx)]
    if isinstance(idx, DTensor):
        return from_local_part(out, idx)
    return DTensor.from_local(out, mesh, rep, run_check=False)
