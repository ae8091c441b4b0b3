# Counterpart of src/repro/core/hlo_analysis.py, named alike so that a reader
# finds it.  The reference parses the compiled HLO of one partition; the port
# has no compiled program, and in its place records the per-rank program
# that DTensor dispatches on each rank's local tensors (`ProgramRecorder`,
# run under `FakeTensorMode` on a fake process group by `launch/dryrun.py`).
# `collective_stats`, `op_histogram`, `total_collective_bytes` and
# `histogram_delta` take that list of recorded calls where the reference
# takes HLO text, with the same output schema.  Serves one of the
# reference's three consumers so far, the dry-run's collective bytes.  Not
# ported yet: `find_scope_labels` (marker location in a compiled program)
# and the card's compiled-kernel histogram against the IR histogram of the
# paper's §V-B (ROADMAP Queue A).
"""Per-rank program analysis: op histograms and collective traffic.

A recorded call (`RecordedOp`) looks like a node of an ATen FX graph (the
``op``, ``target``, ``args`` and ``meta["val"]`` that
`core.unit_of_work.graph_cost` reads), so the recorded program is priced by
the same rules as a traced block.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.unit_of_work import op_name

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# `_c10d_functional` op (what DTensor issues) -> the reference's HLO kind;
# the port issues no collective-permute
C10D_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# the namespaces of the calls that make up the program (not `prim`'s queries
# of a tensor's device or the higher-order operators that wrap calls)
RECORDED = ("aten", "_c10d_functional")


class _Arg:
    """A tensor argument of a recorded call, as an FX node shows it."""
    __slots__ = ("meta",)

    def __init__(self, t: torch.Tensor):
        self.meta = {"val": t}


class RecordedOp:
    """One ATen call of the per-rank program: ``target`` the op overload,
    ``args`` its positional arguments (tensors wrapped so that their
    ``meta["val"]`` holds them), ``meta["val"]`` its result."""
    op = "call_function"
    __slots__ = ("target", "args", "meta")

    def __init__(self, target, args, out):
        self.target = target
        self.args = tuple(_Arg(a) if isinstance(a, torch.Tensor) else a
                          for a in args)
        self.meta = {"val": out}


class ProgramRecorder(TorchDispatchMode):
    """Records every ATen call that reaches plain (local) tensors while it
    is active.  A call on DTensors is handed back to DTensor (a mode runs
    before tensor subclasses), which then dispatches the per-rank ops,
    collectives included, through this mode.  ``ops`` is the program in
    execution order."""

    def __init__(self):
        super().__init__()
        self.ops: List[RecordedOp] = []
        self._paused = 0
        self._patched = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not self._paused and getattr(func, "namespace", "") in RECORDED:
            self.ops.append(RecordedOp(func, args, out))
        return out

    # DTensor derives each op's output shape by running the op on fake
    # tensors of the global shapes (its sharding propagator); those calls
    # pass through this mode too and are not the rank's program, so the
    # recorder pauses while the propagator runs them.
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        inner = SP._propagate_tensor_meta_non_cached
        rec = self

        def paused(prop, op_schema):
            rec._paused += 1
            try:
                return inner(prop, op_schema)
            finally:
                rec._paused -= 1
        SP._propagate_tensor_meta_non_cached = paused
        self._patched = (SP, inner)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        cls, inner = self._patched
        cls._propagate_tensor_meta_non_cached = inner
        return out


def _tensor_bytes(t: Any) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_tensor_bytes(x) for x in t)
    return 0


def op_histogram(ops: Iterable[RecordedOp]) -> Dict[str, int]:
    """Op name -> count over the recorded program."""
    return dict(collections.Counter(op_name(op) for op in ops))


def collective_stats(ops: Iterable[RecordedOp]
                     ) -> Dict[str, Dict[str, float]]:
    """Per collective kind: op count + operand bytes (roofline 3rd term), as
    the reference's; a kind the program does not issue counts 0."""
    stats: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "bytes": 0.0} for k in COLLECTIVES}
    for op in ops:
        if getattr(op.target, "namespace", "") != "_c10d_functional":
            continue
        kind = C10D_KINDS.get(op_name(op))
        if kind is None:                    # wait_tensor, broadcast, ...
            continue
        operand = next((a.meta["val"] for a in op.args
                        if isinstance(a, _Arg)), None)
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += float(_tensor_bytes(operand))
    return stats


def total_collective_bytes(ops: Iterable[RecordedOp]) -> float:
    return sum(v["bytes"] for v in collective_stats(ops).values())


def histogram_delta(a: Dict[str, int], b: Dict[str, int]
                    ) -> List[Tuple[str, int, int]]:
    """Sorted (op, count_a, count_b) where counts differ — the §V-B
    'microcoding' localization view."""
    keys = set(a) | set(b)
    rows = [(k, a.get(k, 0), b.get(k, 0)) for k in keys
            if a.get(k, 0) != b.get(k, 0)]
    return sorted(rows, key=lambda r: -abs(r[1] - r[2]))
