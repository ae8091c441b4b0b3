# Counterpart of src/repro/core/hlo_analysis.py, named alike so that a reader
# finds it; nothing of it is left unported.  The reference parses compiled
# HLO; the port has no compiled program, and serves the reference's three
# consumers so:
#   - the dry-run's collective bytes: `collective_stats`, `op_histogram`,
#     `total_collective_bytes` and `histogram_delta` take the per-rank
#     program that DTensor dispatches on each rank's local tensors
#     (`ProgramRecorder`, run under `FakeTensorMode` on a fake process group
#     by `launch/dryrun.py`) where the reference takes HLO text, with the
#     same output schema; the program's text is `program_text`, and its
#     memory (the reference's `memory_analysis`) is `LiveBytes`, which
#     follows each storage the program creates from its creating call to
#     the release of its last reference;
#   - the model-accuracy study of the paper's §V-B: the portable IR's
#     histogram is `ir_histogram` (the ATen graph on meta tensors, the
#     reference's `jaxpr_histogram`), the compiled side's is
#     `kernel_histogram` (the kernels one call runs on the card, from
#     torch.profiler), and `histogram_delta` localises the difference;
#   - marker location by label: `find_scope_labels` reads a recorded
#     profile, whose user ranges (`models/layers.scope`, `obs.span`) are the
#     reference's `named_scope` metadata in the HLO.
"""Program analysis: op histograms, collective traffic, marker labels.

A recorded call (`RecordedOp`) looks like a node of an ATen FX graph (the
``op``, ``target``, ``args`` and ``meta["val"]`` that
`core.unit_of_work.graph_cost` reads), so the recorded program is priced by
the same rules as a traced block.
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.unit_of_work import TensorMeta, op_name

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


def _metas(x):
    """``x`` with every tensor in it (in lists and tuples) a `TensorMeta`."""
    if isinstance(x, torch.Tensor):
        return TensorMeta(x)
    if isinstance(x, (list, tuple)):
        return (list if isinstance(x, list) else tuple)(_metas(v) for v in x)
    return x


class RecordedOp:
    """One ATen call of the per-rank program: ``target`` the op overload,
    ``args`` its positional arguments (tensors wrapped so that their
    ``meta["val"]`` holds them), ``meta["val"]`` its result; every tensor
    kept as its `TensorMeta`, which the costs read as they read a tensor,
    so that a recording keeps no tensor alive."""
    op = "call_function"
    __slots__ = ("target", "args", "meta")

    def __init__(self, target, args, out):
        self.target = target
        self.args = tuple(_Arg(a) if isinstance(a, TensorMeta) else a
                          for a in _metas(args))
        self.meta = {"val": _metas(out)}


def tree_storages(tree, out: Dict[int, Any]) -> Dict[int, Any]:
    """The distinct buffers of the tensors in ``tree`` (dicts, lists,
    tuples, NamedTuples; a DTensor's local tensor; a numpy array of a train
    state's key), into ``out``: key -> the storage (or array)."""
    if isinstance(tree, DTensor):
        tree = tree._local_tensor
    if isinstance(tree, torch.Tensor):
        s = tree.untyped_storage()
        out[s._cdata] = s
    elif isinstance(tree, np.ndarray):
        out[id(tree)] = tree
    elif isinstance(tree, dict):
        for v in tree.values():
            tree_storages(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tree_storages(v, out)
    return out


class LiveBytes:
    """The memory of a recorded program, under the names of the reference's
    ``compiled.memory_analysis()``.  The arguments' buffers (`arguments`)
    are live throughout.  Every storage that a call of the program creates
    counts from that call to the release of its last reference (a
    `weakref.finalize` on the storage, whose Python object torch keeps for
    as long as the storage lives); a view's or an in-place call's output
    shares a storage already counted and adds nothing.  ``peak`` is the most
    bytes so created that were live at once, after any call."""

    def __init__(self):
        self.arguments: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self._created: Dict[int, int] = {}
        self._lock = threading.RLock()    # a release can come from autograd's thread

    def add_arguments(self, tree) -> None:
        for key, buf in tree_storages(tree, {}).items():
            self.arguments[key] = int(buf.nbytes if isinstance(
                buf, np.ndarray) else buf.nbytes())

    def created(self, out) -> None:
        """Count the storages of a call's outputs that are new."""
        with self._lock:
            for key, s in tree_storages(out, {}).items():
                if key in self._created or key in self.arguments:
                    continue
                n = s.nbytes()
                self._created[key] = n
                self.live += n
                weakref.finalize(s, self._released, key).atexit = False
            self.peak = max(self.peak, self.live)

    def _released(self, key: int) -> None:
        with self._lock:
            self.live -= self._created.pop(key, 0)

    def summary(self, out) -> Dict[str, int]:
        """The reference's ``mem_*`` fields for a program that returned
        ``out``: arguments; outputs, less the bytes that alias an argument
        (a cache written in place, a train state updated in place), which
        are ``alias``; ``temp`` is the peak of live bytes less the arguments
        (the outputs are live at the end, so inside it)."""
        outs = tree_storages(out, {})
        alias = sum(self.arguments[k] for k in outs if k in self.arguments)
        output = sum(b.nbytes() for k, b in outs.items()
                     if k not in self.arguments
                     and isinstance(b, torch.UntypedStorage))
        return {"mem_argument_size_in_bytes": sum(self.arguments.values()),
                "mem_output_size_in_bytes": int(output),
                "mem_temp_size_in_bytes": int(self.peak),
                "mem_alias_size_in_bytes": int(alias)}


class ProgramRecorder(TorchDispatchMode):
    """Records every ATen call that reaches plain (local) tensors while it
    is active.  A call on DTensors is handed back to DTensor (a mode runs
    before tensor subclasses), which then dispatches the per-rank ops,
    collectives included, through this mode.  ``ops`` is the program in
    execution order.  ``memory`` (a `LiveBytes`) follows the storages that
    the program's calls create; the recording keeps no tensor alive.

    A factory function called from Python (``torch.empty``, ...) detaches
    a result that something besides its caller holds as it returns it, and
    a recording that kept every tensor held each one; so the recorder holds
    the last call's outputs until the next call begins.  The program then
    has that ``detach`` as before (the same calls,
    `tests/test_torch_dryrun_memory.py`), and the outputs are let go
    before the next call allocates."""

    def __init__(self):
        super().__init__()
        self.ops: List[RecordedOp] = []
        self.memory = LiveBytes()
        self._held = None
        self._paused = 0
        self._patched = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._held = None
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not self._paused:
            if getattr(func, "namespace", "") in RECORDED:
                self.ops.append(RecordedOp(func, args, out))
            self.memory.created(out)
            self._held = out
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
        self._held = None
        out = super().__exit__(*exc)
        cls, inner = self._patched
        cls._propagate_tensor_meta_non_cached = inner
        return out


def _tensor_bytes(t: Any) -> int:
    if isinstance(t, TensorMeta):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_tensor_bytes(x) for x in t)
    return 0


def program_text(ops: Iterable[RecordedOp]) -> str:
    """The recorded program as text, one line per call, each the name that
    `op_histogram` counts it under: the counterpart of the reference's HLO
    text, whose length is its ``hlo_bytes``."""
    return "".join(op_name(op) + "\n" for op in ops)


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


# ---------------------------------------------------------------------------
# the §V-B study: the portable IR against what the card runs
# ---------------------------------------------------------------------------

# the port's own kernels (K1, K2, K3), by the names their launches carry
PORT_KERNEL_NAMES = {
    "flash_attention": ("flash_attention_kernel",
                        "flash_attention_bf16_kernel"),
    "flash_decode": ("flash_decode_kernel",),
    "ssd_intra": ("ssd_intra_kernel", "ssd_tc_kernel"),
}


def ir_histogram(fn: Callable, *args) -> Dict[str, int]:
    """Op name -> count over the ATen graph of ``fn`` at ``args`` (as a rule
    meta tensors; `unit_of_work.trace_graph`): the portable IR's histogram,
    the role of the reference's ``jaxpr_histogram``.  Its total is
    ``trace_cost(fn, *args).ops``.  A kernel wrapper on meta tensors takes
    its plain version, so the IR of a ``"cuda"``-impl model holds the plain
    attention and SSD where the card runs K1 and K3: a delta that the study
    is there to show."""
    from repro_torch.core.unit_of_work import trace_graph
    graph = trace_graph(fn, *args)
    return dict(collections.Counter(
        op_name(n) for n in graph.graph.nodes if n.op == "call_function"))


def _strip_groups(s: str) -> str:
    """``s`` without its bracketed groups, ``<...>`` and ``(...)`` nested in
    one another, at any depth."""
    out, depth = [], 0
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def kernel_name(name: str) -> str:
    """A device kernel's demangled name normalised: no ``void``, no
    namespaces, no template arguments, no parameter list
    (``void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)`` ->
    ``vectorized_elementwise_kernel``).  Names without them (cuBLAS's, the
    port's own kernels) stay as they are; copies and fills keep theirs
    (``Memcpy DtoD (Device -> Device)``)."""
    s = name.strip()
    if s.startswith(("Memcpy", "Memset")):
        return s
    if s.startswith("void "):
        s = s[len("void "):]
    s = _strip_groups(s).strip()
    return s.rsplit("::", 1)[-1].strip()


# How `profile_call` profiles a call on the card.  On the H100 with torch
# 2.11 a profile at times holds a launch whose device event is missing (its
# CPU-side launch was recorded): most often the profile's first launch,
# whatever the time between the profile's start and it, and now and then a
# few dozen within the call.  So the call runs in a `CALL_RANGE` range after
# `LEAD_IN_LAUNCHES` one-element fills, which take the place of the first
# launches; `device_kernels` links each of the call's launches to its
# device event and raises `LostDeviceEvents` where one has none; and a
# profile that lost events is taken again, up to `PROFILE_ATTEMPTS` times.
CALL_RANGE = "profile_call"
LEAD_IN_LAUNCHES = 8
PROFILE_ATTEMPTS = 4
# CPU-side CUDA API calls that each put one event on the device
_LAUNCH_APIS = ("LaunchKernel", "Memcpy", "Memset")


class LostDeviceEvents(RuntimeError):
    """A profile holds a launch, copy or fill of the call with no device
    event: a histogram of it would be wrong, not approximate.  ``kernels``
    holds the call's device events that the profile kept, ``lost_ops`` the
    op that made each launch whose event it lost (`_launching_op`)."""

    def __init__(self, msg: str, kernels=(), lost_ops=()):
        super().__init__(msg)
        self.kernels, self.lost_ops = list(kernels), list(lost_ops)


def _profile_once(fn: Callable, args: tuple, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            lead = torch.empty(1, device=torch.cuda.current_device())
            for _ in range(LEAD_IN_LAUNCHES):
                lead.fill_(0.0)
            torch.cuda.synchronize()
            with record_function(CALL_RANGE):
                fn(*args)
            torch.cuda.synchronize()
        else:
            fn(*args)
    return prof


def profile_call(fn: Callable, *args, cuda: bool = True):
    """A ``torch.profiler`` profile of one call of ``fn`` (CPU activity, and
    CUDA activity with ``cuda``; the call is synchronised before the
    profile closes).  With ``cuda`` the call runs inside a `CALL_RANGE`
    range after `LEAD_IN_LAUNCHES` fills that `device_kernels` leaves out,
    and a profile that lost device events is taken again (``fn`` must bear
    being called again): the profile returned holds every device event of
    its call, and its ``attempts`` says how many profiles were taken.
    Raises `LostDeviceEvents` if `PROFILE_ATTEMPTS` profiles all lost
    some."""
    if not cuda:
        return _profile_once(fn, args, cuda)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        prof = _profile_once(fn, args, cuda)
        try:
            device_kernels(prof)
        except LostDeviceEvents:
            if attempt == PROFILE_ATTEMPTS:
                raise
            continue
        prof.attempts = attempt
        return prof


def _is_device(e) -> bool:
    return e.device_type.name != "CPU"


def _is_runtime(e) -> bool:
    """A CPU-side CUDA API call (``cuda...``, or the lower-level ``cu...``)."""
    return not _is_device(e) and e.name.startswith("cu")


def device_kernels(prof) -> list:
    """The device events of a profile that are work (kernels, copies and
    fills), not device-side annotation spans: those of the call inside the
    `CALL_RANGE` range where `profile_call` made the profile, else all.
    Each is linked to its CPU-side launch by correlation id.  Raises
    `LostDeviceEvents` if a launch, copy or fill of the call has none."""
    events = prof.events()
    work = [e for e in events if _is_device(e) and not e.is_user_annotation]
    if not work:
        return []
    call = [e for e in events if not _is_device(e) and e.name == CALL_RANGE]
    runtime = [e for e in events if _is_runtime(e) and (
        not call or call[0].time_range.start <= e.time_range.start
        <= call[0].time_range.end)]
    ids = {e.id for e in runtime}
    kernels = [e for e in work if e.id in ids]
    done = {e.id for e in kernels}
    lost = [e for e in runtime
            if any(a in e.name for a in _LAUNCH_APIS) and e.id not in done]
    if lost:
        raise LostDeviceEvents(
            f"the profile lost the device events of {len(lost)} of the "
            f"call's {len(kernels) + len(lost)} launches, copies and fills "
            f"({sorted({e.name for e in lost})}); its kernel histogram "
            "would be wrong", kernels, [_launching_op(e) for e in lost])
    return kernels


def _launching_op(e) -> str:
    """The ATen op whose call made the CPU-side API call ``e`` (the
    innermost one around it), or the API call's own name."""
    p = getattr(e, "cpu_parent", None)
    while p is not None and not _aten(p):
        p = p.cpu_parent
    return e.name if p is None else p.name


def kernel_histogram_of(prof) -> Dict[str, int]:
    """Normalised kernel name (`kernel_name`) -> launches in a recorded
    profile.  Raises if it holds no device kernel (no CUDA activity, or no
    CUPTI): a profile of the CPU is no stand-in for the card's."""
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError(
            "the profile holds no device kernel (no CUDA activity was "
            "recorded, or CUPTI is not available); the kernel histogram "
            "has no CPU stand-in")
    return dict(collections.Counter(kernel_name(e.name) for e in kernels))


def kernel_histogram(fn: Callable, *args) -> Dict[str, int]:
    """The compiled side of the §V-B study on the card: one warm call of
    ``fn`` (its first call, outside the profile, loads every kernel), then
    one call under ``torch.profiler`` with CUDA activity (`profile_call`);
    normalised kernel name -> launches, copies and fills under their own
    names.  Raises where there is no CUDA device, the profile holds no
    device kernel, or every profile taken lost device events."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_histogram counts the kernels a call "
                           "launches on a CUDA device, and there is none")
    fn(*args)
    torch.cuda.synchronize()
    return kernel_histogram_of(profile_call(fn, *args, cuda=True))


def _aten(e) -> bool:
    return e.name.startswith("aten::")


def _top_level(e, needle=None) -> bool:
    """Whether ATen op ``e`` has no other ATen op around it (what the caller
    ran, not what that decomposes into) up to the root, or, with
    ``needle``, up to a range whose label contains it (then it must lie in
    one)."""
    p = e.cpu_parent
    while p is not None:
        if _aten(p):
            return False
        if needle is not None and needle in p.name:
            return True
        p = p.cpu_parent
    return needle is None


def cpu_op_histogram(prof) -> Dict[str, int]:
    """ATen op name -> count over the top-level ATen ops of a CPU profile:
    the compiled side of the §V-B study where there is no card (the ops the
    CPU ran, not kernels)."""
    return dict(collections.Counter(
        e.name[len("aten::"):] for e in prof.events()
        if not _is_device(e) and _aten(e) and _top_level(e)))


def find_scope_labels(prof, needle: str) -> List[str]:
    """The executed ops of a recorded profile of one call whose launch lies
    inside a range whose label contains ``needle`` (`models/layers.scope`):
    zero-overhead marker location (paper §III-D2; the reference reads the
    ``named_scope`` metadata of its compiled HLO).  On the card they are the
    device kernels (normalised names) that run inside a device-side span of
    such a range: the profiler draws one over the kernels of each range
    instance on the device's timeline, and a kernel launched from Python, as
    the port's own are, has no launching ATen op to link it to its range.
    In a profile without device kernels they are the ATen ops that the
    range ran, each as its top-level op."""
    events = prof.events()
    kernels = device_kernels(prof)
    if not kernels:
        return [e.name[len("aten::"):] for e in events
                if not _is_device(e) and _aten(e) and _top_level(e, needle)]
    spans = [e for e in events if _is_device(e) and e.is_user_annotation
             and needle in e.name]
    return [kernel_name(k.name) for k in kernels
            if any(sp.device_index == k.device_index
                   and sp.time_range.start <= k.time_range.start
                   and k.time_range.end <= sp.time_range.end
                   for sp in spans)]
