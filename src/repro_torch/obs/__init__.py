# Counterpart of src/repro/obs/__init__.py; nothing of it is left unported.
# Where the port departs: `span` also answers a recording torch.profiler (a
# `record_function` range of the span's name, with the tracer off too; see
# `obs.trace`, whose spans are stamped on the profiler's Unix clock), and
# `timed` is the port's own (a span whose duration the registry keeps), as
# are `capturing` and `CountRecord`, for a step captured into a CUDA graph.
"""``repro_torch.obs`` — unified tracing + metrics across the nugget lifecycle.

Zero-dependency observability with three pieces (see
``docs/observability.md`` and, for the port's departures and spans,
``docs/observability_torch.md``):

- :mod:`repro_torch.obs.trace`   — nestable spans, JSONL sink, Chrome-trace export,
- :mod:`repro_torch.obs.metrics` — counters / gauges / histograms + snapshots,
- :mod:`repro_torch.obs.log`     — structured ``key=value`` logging
  (``REPRO_LOG_LEVEL``).

Module-level singletons keep instrumentation one import away from any hot
loop::

    from repro_torch import obs
    with obs.span("stage.profile", key=digest) as sp:
        ...
        sp.event("cache_miss")
    obs.metrics().count("store.miss")

Tracing is **disabled by default** — ``obs.span()`` then returns a shared
no-op span (budgeted <2%% of a training step by
``benchmarks/bench_hook_overhead.py``), unless a ``torch.profiler`` records:
then it opens a ``record_function`` range of the same name, so that the
profile shows the span (the model's block labels, ``models/layers.scope``,
are such spans).  ``obs.timed()`` is a span whose duration also goes into
the registry's histogram of its name, tracing on or off, except while a
CUDA graph captures (`capturing`): a capture runs no step.  `CountRecord`
keeps what a captured step counted, to count it again at each replay.
Enable tracing per
process with ``obs.configure(trace=True, trace_dir=...)`` or the
``REPRO_TRACE`` env var (``1`` to buffer in memory, a path to also stream
JSONL there).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.obs import log  # noqa: F401  (re-exported module)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN, ProfilerRange, Span, Tracer, chrome_trace, profiling,
    read_events, span_summary, tracing,
)

ENV_TRACE = "REPRO_TRACE"

_tracer = Tracer(enabled=False)
_metrics = MetricsRegistry()


# -- accessors ---------------------------------------------------------
def tracer() -> Tracer:
    return _tracer


def metrics() -> MetricsRegistry:
    return _metrics


def span(name: str, **attrs: Any):
    """Open a span on the process tracer.  Disabled, it is a range of a
    recording profiler (`profiling`), else the no-op singleton."""
    t = _tracer
    if t.enabled:
        return t.span(name, **attrs)
    if profiling():
        return ProfilerRange(name)
    return NULL_SPAN


class _Timed:
    __slots__ = ("name", "attrs", "_span", "_t0")

    def __init__(self, name: str, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._span = span(self.name, **self.attrs).__enter__()
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        if not capturing():
            _metrics.observe(self.name, dt)


def timed(name: str, **attrs: Any) -> _Timed:
    """A span (as `span`) whose duration in seconds is also observed into
    the registry's histogram ``name``, whether or not the tracer is on: one
    clock pair and one observation a call.  A span that ends while a CUDA
    graph captures observes nothing: the capture is not a step."""
    return _Timed(name, attrs)


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (its kernels
    are recorded, and none runs)."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _counter_values() -> Dict[str, float]:
    return {name: s["value"] for name, s in _metrics.snapshot().items()
            if s["type"] == "counter"}


class CountRecord:
    """What a step counted into the registry's counters while a CUDA graph
    captured it (its MoE counts, the kernel wrappers' launches), counted
    again at each `replay`: a replay runs the step's kernels and none of
    its Python.  The block it opens is the capture; the counts made in it
    stand once, for the capture's step."""

    def __init__(self):
        self.counts: Dict[str, float] = {}

    def __enter__(self) -> "CountRecord":
        self._before = _counter_values()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        before = self._before
        self.counts = {name: v - before.get(name, 0)
                       for name, v in _counter_values().items()
                       if v != before.get(name, 0)}

    def replay(self) -> None:
        for name, amount in self.counts.items():
            _metrics.count(name, amount)


def event(name: str, **attrs: Any) -> None:
    t = _tracer
    if t.enabled:
        t.event(name, **attrs)


def enabled() -> bool:
    return _tracer.enabled


def set_worker(name: Optional[str]) -> None:
    """Tag the calling thread with a logical worker name (scheduler pools
    call this); subsequent spans/events carry it as a ``worker`` attr."""
    _tracer.set_worker(name)


# -- configuration -----------------------------------------------------
def configure(*, trace: Optional[bool] = None,
              trace_dir: Optional[str] = None,
              reset_metrics: bool = False) -> Tracer:
    """(Re)configure process-wide observability.

    ``trace=True`` swaps in a fresh enabled tracer; with ``trace_dir`` its
    events also stream to ``<trace_dir>/trace.jsonl`` as they happen.
    ``trace=False`` swaps back to a disabled tracer.  Returns the active
    tracer either way.
    """
    global _tracer
    if trace is not None:
        _tracer.close()
        sink = (os.path.join(trace_dir, "trace.jsonl")
                if (trace and trace_dir) else None)
        _tracer = Tracer(enabled=bool(trace), sink=sink)
    if reset_metrics:
        _metrics.reset()
    return _tracer


def configure_from_env() -> Tracer:
    """Honor ``REPRO_TRACE``: unset/``0``/empty = disabled, ``1`` = buffer
    in memory, any other value = treat as a directory and stream JSONL."""
    raw = os.environ.get(ENV_TRACE, "").strip()
    if raw in ("", "0", "false"):
        return configure(trace=False)
    if raw in ("1", "true"):
        return configure(trace=True)
    return configure(trace=True, trace_dir=raw)
