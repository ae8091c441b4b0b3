# Counterpart of src/repro/core/unit_of_work.py.  The port's IR is the ATen
# graph where the reference's is the jaxpr; `jaxpr_cost` becomes `graph_cost`.
# Control-flow sub-graphs (scan / while / cond trip counts) have no use yet:
# the port's layer loop is a Python loop and blocks are traced one by one.
"""Unit of work: executed ATen operations.

The paper counts executed LLVM IR instructions; the portable IR of PyTorch is
the ATen graph.  A block's static "IR size" is the number of ATen calls its
traced body contains, exactly as an LLVM IRBB's size is its instruction
count.  A FLOP-weighted variant is the secondary unit of work: matrix
products count ``2 * M * N * K``, every other op its output elements, and
views, reshapes, casts and data movement are free.

Op counts are IR-specific and need not equal the reference's jaxpr counts
(elementwise functions decompose differently in ATen); matrix-product FLOPs
do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

# ops that move or reinterpret data: one executed op, no FLOPs (the ATen
# counterparts of the reference's `_ELTWISE_FREE` jaxpr primitives)
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "squeeze", "unsqueeze",
    "permute", "transpose", "t", "slice", "select", "split", "split_with_sizes",
    "unbind", "chunk", "cat", "stack", "constant_pad_nd", "flip", "index",
    "index_select", "gather", "scatter", "scatter_add", "index_put",
    "index_put_", "embedding", "_to_copy", "to", "clone", "copy", "copy_",
    "contiguous", "alias", "detach", "lift_fresh", "lift_fresh_copy",
    "arange", "full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
    "empty", "empty_like", "scalar_tensor", "new_empty", "new_zeros",
    "new_ones", "new_full", "getitem",
    # collectives of a recorded per-rank program (core/hlo_analysis.py)
    "all_reduce", "all_reduce_", "all_gather_into_tensor",
    "reduce_scatter_tensor", "all_to_all_single", "wait_tensor",
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv"}


def op_name(node) -> str:
    """``aten.bmm.default`` -> ``bmm``."""
    target = node.target
    name = getattr(target, "__name__", str(target))
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        name = getattr(packet, "__name__", name)
    return name.split(".")[0]


def is_matmul(node) -> bool:
    return node.op == "call_function" and op_name(node) in _MATMUL


class TensorMeta:
    """A tensor's shape and dtype, all that the cost rules read of it: what
    a recorded program keeps of a tensor, so as not to keep the tensor
    alive (`core.hlo_analysis.ProgramRecorder`)."""
    __slots__ = ("shape", "dtype")

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = t.shape, t.dtype

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.dtype.itemsize


def _vals(x):
    """Tensor-like metadata values inside a node's ``meta['val']``."""
    if isinstance(x, (torch.Tensor, TensorMeta)):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _vals(v)]
    return []


def _node_vals(node):
    return _vals(node.meta.get("val"))


def node_flops(node) -> float:
    """Cheap static FLOP estimate for one ATen call."""
    name = op_name(node)
    outs = _node_vals(node)
    if name in _MATMUL:
        # contraction length: last axis of the first matrix operand (addmm /
        # baddbmm carry the bias first)
        mats = [a for a in node.args if hasattr(a, "meta")]
        lhs = _node_vals(mats[-2])[0]
        return 2.0 * math.prod(outs[0].shape) * lhs.shape[-1]
    if name in _FREE:
        return 0.0
    return float(sum(math.prod(t.shape) for t in outs))


def node_bytes(node) -> float:
    """Operand+result bytes of one call (no-fusion traffic upper bound)."""
    total = 0.0
    ins = [a for a in node.args if hasattr(a, "meta")]
    for t in [v for a in ins for v in _node_vals(a)] + _node_vals(node):
        total += math.prod(t.shape) * t.element_size()
    return total


@dataclasses.dataclass
class IRCost:
    ops: float            # executed ATen calls (unit of work)
    flops: float          # FLOP-weighted secondary unit
    unbounded_loops: int  # data-dependent loops encountered (none yet)
    bytes: float = 0.0    # operand+result bytes (no-fusion upper bound)

    def __add__(self, o: "IRCost") -> "IRCost":
        return IRCost(self.ops + o.ops, self.flops + o.flops,
                      self.unbounded_loops + o.unbounded_loops,
                      self.bytes + o.bytes)

    def scale(self, m: float) -> "IRCost":
        return IRCost(self.ops * m, self.flops * m, self.unbounded_loops,
                      self.bytes * m)


def graph_cost(gm) -> IRCost:
    """Cost of an ATen graph, or of a recorded program: any iterable of
    nodes (`core.hlo_analysis.RecordedOp`)."""
    total = IRCost(0.0, 0.0, 0)
    nodes = gm.graph.nodes if hasattr(gm, "graph") else gm
    for node in nodes:
        if node.op != "call_function":
            continue
        total = total + IRCost(1.0, node_flops(node), 0, node_bytes(node))
    return total


def matmul_flops(gm) -> float:
    """FLOPs of the graph's (or a recorded program's) matrix products
    alone."""
    nodes = gm.graph.nodes if hasattr(gm, "graph") else gm
    return sum(node_flops(n) for n in nodes if is_matmul(n))


def trace_graph(fn: Callable, *args) -> torch.fx.GraphModule:
    """ATen graph of ``fn`` at the given arguments (pytrees of tensors, as a
    rule on the ``meta`` device: shapes and dtypes only, no allocation)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.no_grad():
        return make_fx(fn, tracing_mode="fake")(*args)


def trace_cost(fn: Callable, *args) -> IRCost:
    """IR cost of ``fn`` traced at the given (meta or real) arguments — the
    analogue of an LLVM pass measuring an IRBB's size."""
    return graph_cost(trace_graph(fn, *args))
