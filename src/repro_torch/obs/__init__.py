# Counterpart of src/repro/obs/__init__.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""``repro_torch.obs`` — unified tracing + metrics across the nugget lifecycle.

Zero-dependency observability with three pieces (see
``docs/observability.md``):

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
``benchmarks/bench_hook_overhead.py``).  Enable per process with
``obs.configure(trace=True, trace_dir=...)`` or the ``REPRO_TRACE`` env var
(``1`` to buffer in memory, a path to also stream JSONL there).
"""
from __future__ import annotations

import os
from typing import Any, Optional

from repro_torch.obs import log  # noqa: F401  (re-exported module)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN, Span, Tracer, chrome_trace, read_events, span_summary,
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
    """Open a span on the process tracer (no-op singleton when disabled)."""
    t = _tracer
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, **attrs)


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
