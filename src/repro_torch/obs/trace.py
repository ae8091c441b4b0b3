# Counterpart of src/repro/obs/trace.py, where the port departs from it in
# two ways.  Spans start on the clock that torch.profiler stamps (Unix
# nanoseconds, as `time.time_ns()` reads them; the Chrome export's `ts` is
# Unix microseconds), where the reference counts `time.perf_counter()` from
# the tracer's own epoch: a program trace and a profile then lie on one
# timeline.  Durations stay on the monotonic clock (`perf_counter_ns`).
# And while a profiler records, outside a `make_fx` trace, fake tensors or a
# compile, a span also opens a `record_function` range of its name
# (`profiling`).
"""Tracer: nestable spans over a thread-safe in-process buffer.

The tracer is the timing half of ``repro_torch.obs`` (the metrics half lives in
``repro_torch.obs.metrics``).  Spans measure *where wall time goes* across the
nugget lifecycle — ``pipeline.run`` > ``stage.profile`` >
``intervals.analyze_batch`` — and export to two sinks:

- **JSONL** (``trace.jsonl``): one event object per line, append-friendly,
  mergeable across processes/hosts (``repro_torch.launch.obs merge``),
- **Chrome trace** (``trace.json``): the ``traceEvents`` format that
  ``chrome://tracing`` and https://ui.perfetto.dev load directly, so a full
  pipeline run can be inspected in a real trace viewer.

Timestamps are Unix time (``time.time_ns()``), the clock of
``torch.profiler``'s events, and durations are monotonic
(``time.perf_counter_ns()``, which no clock step moves): ``ts`` in the
exports is Unix microseconds, so a trace of the program and a profiler's
``export_chrome_trace`` merge onto one timeline (``python -m
repro_torch.launch.obs``, which adds a profiler export's
``baseTimeNanoseconds`` back to its ``ts``).  While a profiler records, a
span also opens a ``record_function`` range of its name (`ProfilerRange`), so the
profile shows the program's phases over the kernels they launch (on the
card, a device-side span of each range encloses its kernels).

Disabled (the default) the tracer is a handful of attribute reads per
``span()`` call — the hot-loop budget is enforced by
``benchmarks/bench_hook_overhead.py`` (<2%% of a training step).  Span
nesting is tracked per thread (``threading.local``); buffer appends take a
lock, so concurrent stages/chunks trace safely.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# a user range of the profiler (``RecordScope.USER_SCOPE``), opened and closed
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit

# Chrome-trace phases used here: X = complete span, i = instant event,
# M = metadata (process/thread names).
_PH_SPAN = "X"
_PH_INSTANT = "i"


def tracing() -> bool:
    """Whether a ``make_fx`` trace, a fake-tensor mode or a compile is
    active, where a profiler range would become a node of the program."""
    keys = torch._C._TorchDispatchModeKey
    return (torch._C._get_dispatch_mode(keys.PROXY) is not None
            or torch._C._get_dispatch_mode(keys.FAKE) is not None
            or torch.compiler.is_compiling())


def profiling() -> bool:
    """Whether a span should open a ``record_function`` range: a profiler
    records and no trace runs (there the range would be an ATen op, a node
    of the graph whose nodes the unit of work counts)."""
    return _autograd_profiler._is_profiler_enabled and not tracing()


class ProfilerRange:
    """A span that only a profile sees: a user range of its name, as
    ``record_function`` opens one, with the span API's ``set`` and ``event``
    as no-ops (what ``span()`` returns while a profiler records and the
    tracer is off).  It opens the range directly, not through the two ATen
    ops (enter, exit) of ``record_function``, which the profiler records as
    events of their own at several times the range's cost."""

    __slots__ = ("name", "_handle")

    def __init__(self, name: str):
        self.name = name
        self._handle = None

    def __enter__(self) -> "ProfilerRange":
        self._handle = _range_enter(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _range_exit(self._handle)

    def set(self, **attrs: Any) -> "ProfilerRange":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        return None


class Span:
    """One open span.  Use as a context manager (``with tracer.span(...)``);
    ``event()`` records instants inside it, ``set()`` attaches attributes
    that land in the Chrome-trace ``args`` dict."""

    __slots__ = ("tracer", "name", "attrs", "t0", "_p0", "_tid", "_depth",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0
        self._p0 = 0
        self._tid = 0
        self._depth = 0
        self._range = None

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "Span":
        # the start is stamped on the Unix clock (for the merge) and the
        # duration taken on the monotonic one, which no clock step moves;
        # both are read outside the profiler range, the monotonic one first,
        # so the range nests inside the span on a merged timeline
        self._p0 = time.perf_counter_ns()
        self.t0 = time.time_ns()
        self._tid = threading.get_ident()
        self._depth = self.tracer._push()
        if profiling():
            self._range = ProfilerRange(self.name).__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        p1 = time.perf_counter_ns()
        self.tracer._pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        worker = self.tracer.worker()
        if worker is not None:
            self.attrs.setdefault("worker", worker)
        self.tracer._emit({
            "ph": _PH_SPAN, "name": self.name, "cat": "span",
            "ts": self.tracer._us(self.t0), "dur": (p1 - self._p0) / 1e3,
            "pid": self.tracer.pid, "tid": self._tid,
            "args": self.attrs,
        })

    # -- span API ------------------------------------------------------
    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        self.tracer._emit({
            "ph": _PH_INSTANT, "name": f"{self.name}.{name}", "cat": "event",
            "ts": self.tracer._us(time.time_ns()), "s": "t",
            "pid": self.tracer.pid, "tid": threading.get_ident(),
            "args": attrs,
        })


class _NullSpan:
    """Disabled-path span: every operation is a no-op.  A single shared
    instance is returned for all ``span()`` calls while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe in-process trace buffer with JSONL/Chrome-trace sinks.

    ``enabled=False`` (default): ``span()`` returns the shared
    :data:`NULL_SPAN` without allocating; ``event()`` returns immediately.
    A ``sink`` path makes every emit also append a JSONL line (crash-safe:
    the buffer-only mode loses events on a hard crash, the sink does not).
    """

    def __init__(self, enabled: bool = False, sink: Optional[str] = None,
                 process_name: str = "repro"):
        self.enabled = enabled
        self.pid = os.getpid()
        self.process_name = process_name
        self._buf: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sink_path = sink
        self._sink_file = None
        # worker tagging: per-thread logical worker names (set by pool
        # schedulers) so concurrent spans render as named tracks
        self._thread_names: Dict[int, str] = {}
        if sink:
            os.makedirs(os.path.dirname(os.path.abspath(sink)), exist_ok=True)
            self._sink_file = open(sink, "a")

    # -- internals -----------------------------------------------------
    @staticmethod
    def _us(t_ns: int) -> float:
        """Unix nanoseconds as the exports' Unix microseconds."""
        return t_ns / 1e3

    def _push(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _pop(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._buf.append(ev)
            if self._sink_file is not None:
                self._sink_file.write(json.dumps(ev) + "\n")
                self._sink_file.flush()

    # -- worker tagging ------------------------------------------------
    def set_worker(self, name: Optional[str]) -> None:
        """Tag the calling thread with a logical worker name.  Every span
        and event the thread emits afterwards carries a ``worker`` attr,
        and the Chrome-trace export names the thread's track after it."""
        self._local.worker = name
        if name is not None:
            with self._lock:
                self._thread_names[threading.get_ident()] = name

    def worker(self) -> Optional[str]:
        """The calling thread's worker name (None when untagged)."""
        return getattr(self._local, "worker", None)

    # -- public API ----------------------------------------------------
    def span(self, name: str, **attrs: Any):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        worker = self.worker()
        if worker is not None:
            attrs.setdefault("worker", worker)
        self._emit({
            "ph": _PH_INSTANT, "name": name, "cat": "event",
            "ts": self._us(time.time_ns()), "s": "t",
            "pid": self.pid, "tid": threading.get_ident(),
            "args": attrs,
        })

    def depth(self) -> int:
        """Current span nesting depth on the calling thread."""
        return getattr(self._local, "depth", 0)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def close(self) -> None:
        with self._lock:
            if self._sink_file is not None:
                self._sink_file.close()
                self._sink_file = None

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The buffer as a Chrome-trace / Perfetto ``traceEvents`` doc."""
        return chrome_trace(self.events(), process_name=self.process_name,
                            pid=self.pid)

    def write_chrome(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path

    def write_jsonl(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")
        return path


def chrome_trace(events: List[Dict[str, Any]], *, process_name: str = "repro",
                 pid: Optional[int] = None) -> Dict[str, Any]:
    """Wrap raw events into a Chrome-trace document, prepending process
    metadata so the viewer shows a named track.  Threads whose events
    carry a ``worker`` attr (scheduler pool threads) additionally get
    ``thread_name`` metadata, so a merged multi-worker trace renders the
    parallel timeline as named worker tracks."""
    meta: List[Dict[str, Any]] = []
    # a profiler export names some tracks by a string pid
    pids = sorted({ev.get("pid", 0) for ev in events} | ({pid} - {None}),
                  key=str)
    for p in pids:
        meta.append({"ph": "M", "name": "process_name", "pid": p, "tid": 0,
                     "args": {"name": f"{process_name}:{p}"}})
    workers: Dict[tuple, str] = {}
    for ev in events:
        w = (ev.get("args") or {}).get("worker")
        if w and "tid" in ev:
            workers[(ev.get("pid", 0), ev["tid"])] = w
    for (p, t), w in sorted(workers.items(), key=lambda kv: str(kv[0])):
        meta.append({"ph": "M", "name": "thread_name", "pid": p, "tid": t,
                     "args": {"name": str(w)}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def read_events(path: str) -> List[Dict[str, Any]]:
    """Load events from a ``trace.jsonl`` or a Chrome ``trace.json`` file
    (metadata records are dropped so merges do not duplicate them).  A
    ``torch.profiler`` export counts its ``ts`` from ``baseTimeNanoseconds``;
    that base is added back, so its events lie in Unix microseconds, as the
    tracer's do."""
    with open(path) as f:
        text = f.read()
    try:                                      # chrome trace document...
        doc = json.loads(text)
        if isinstance(doc, dict) and "traceEvents" in doc:
            evs = doc["traceEvents"]
            base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
            if base_us:
                evs = [dict(ev, ts=ev["ts"] + base_us) if "ts" in ev else ev
                       for ev in evs]
        elif isinstance(doc, list):
            evs = doc                         # bare traceEvents array
        else:
            evs = [doc]                       # single-line jsonl
    except json.JSONDecodeError:              # ...else jsonl, one per line
        evs = [json.loads(line) for line in text.splitlines() if line.strip()]
    return [ev for ev in evs if ev.get("ph") != "M"]


def span_summary(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate complete-span events by name: count, total/mean/max ms."""
    agg: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ph") != _PH_SPAN:
            continue
        a = agg.setdefault(ev["name"], {"name": ev["name"], "count": 0,
                                        "total_ms": 0.0, "max_ms": 0.0})
        dur_ms = ev.get("dur", 0) / 1e3
        a["count"] += 1
        a["total_ms"] += dur_ms
        a["max_ms"] = max(a["max_ms"], dur_ms)
    out = sorted(agg.values(), key=lambda a: -a["total_ms"])
    for a in out:
        a["mean_ms"] = a["total_ms"] / max(a["count"], 1)
    return out
