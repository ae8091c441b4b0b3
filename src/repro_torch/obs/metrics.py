# Counterpart of src/repro/obs/metrics.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""MetricsRegistry: counters, gauges and histograms for the lifecycle.

The registry is the always-on half of ``repro_torch.obs`` (spans can be switched
off; metric updates are cheap enough to leave on everywhere): cache
hits/misses and put-bytes from the ``ArtifactStore``, intervals/s from the
batch analyzer, per-step loss/wall-time/tokens-per-s from ``Trainer`` and
``ServeEngine``, unit-of-work totals from ``WorkMeter`` readbacks.

Three instrument kinds, all thread-safe under one registry lock:

- ``Counter``  — monotone float/int total (``inc``),
- ``Gauge``    — last-write-wins value (``set``),
- ``Histogram``— count/sum/min/max plus a bounded reservoir of recent
  observations for percentile estimates (``observe``).

``snapshot()`` returns a plain-JSON dict (embedded into the pipeline run
manifest); ``report()`` renders a human table for ``--report`` CLIs.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self) -> Dict[str, Any]:
        v = self.value
        return {"type": "counter", "value": int(v) if v == int(v) else v}


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Streaming count/sum/min/max + a bounded ring of recent observations
    (``window``) from which quantiles are estimated.  The ring bounds
    memory for arbitrarily long runs — the full-run aggregates stay exact,
    quantiles reflect the recent window."""

    __slots__ = ("name", "count", "sum", "min", "max", "_recent")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._recent: Deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._recent.append(v)

    def quantile(self, q: float) -> float:
        if not self._recent:
            return 0.0
        vals = sorted(self._recent)
        i = min(len(vals) - 1, max(0, int(q * (len(vals) - 1) + 0.5)))
        return vals[i]

    def snapshot(self) -> Dict[str, Any]:
        if not self.count:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "mean": self.sum / self.count, "min": self.min,
                "max": self.max, "p50": self.quantile(0.5),
                "p95": self.quantile(0.95)}


class MetricsRegistry:
    """Named instruments behind one lock.  Accessors are
    get-or-create, so call sites never pre-register; the convenience
    mutators (``count``/``record``/``observe``) are single calls usable
    from hot loops."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    # -- instruments ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 512) -> Histogram:
        return self._get(name, Histogram, window=window)

    # -- one-call mutators ----------------------------------------------
    def count(self, name: str, amount: float = 1.0) -> None:
        self.counter(name).inc(amount)

    def record(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    # -- export ---------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def value(self, name: str) -> Optional[float]:
        """Counter/gauge value (None if absent; histograms use snapshot)."""
        with self._lock:
            m = self._metrics.get(name)
        return getattr(m, "value", None) if m is not None else None

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return path

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def report(self) -> str:
        """Human-readable fixed-width table of every instrument."""
        snap = self.snapshot()
        if not snap:
            return "(no metrics recorded)"
        w = max(len(n) for n in snap)
        lines = [f"{'metric'.ljust(w)}  type       value"]
        for name, s in snap.items():
            if s["type"] == "histogram":
                if not s["count"]:
                    val = "count=0"
                else:
                    val = (f"count={s['count']} mean={s['mean']:.6g} "
                           f"p50={s['p50']:.6g} p95={s['p95']:.6g} "
                           f"max={s['max']:.6g}")
            else:
                val = f"{s['value']:.6g}"
            lines.append(f"{name.ljust(w)}  {s['type']:<9}  {val}")
        return "\n".join(lines)
