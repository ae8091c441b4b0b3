"""The arithmetic of the per-layer metrics, read from a run's record (the
window by the host's clock, the program's counters) and from the traced
slice.  Each metric's own file under ``metrics/`` binds one of these; a
reader that finds nothing to read returns ``None``, and the metric is left
out of the result."""
from __future__ import annotations

from typing import List, Optional

from portbench.harness.program import PEAK_BF16_FLOPS, bound_s
from portbench.harness.trace import kernels_matching


def ms_per_iter(run: dict) -> Optional[float]:
    """The window over the engine iterations that the program's
    ``serve.prefill_iters`` and ``serve.decode_iters`` counted in it."""
    if not run.get("iters"):
        return None
    return 1e3 * run["window_s"] / run["iters"]


def tpot_p95_ms(run: dict) -> Optional[float]:
    """The window's 95th-percentile time per output token."""
    return run.get("tpot_p95_ms")


def finalize_ms(run: dict) -> Optional[float]:
    """The harness's clock around the program's ``profile()``."""
    return 1e3 * run["finalize_s"]


def mfu(run: dict) -> Optional[float]:
    """The operations the window's work needs (the benchmark's own count)
    over the window at the card's bf16 peak, in %."""
    if not run.get("flops"):
        return None
    return 100.0 * run["flops"] / (run["window_s"] * PEAK_BF16_FLOPS)


def idle_share(run: dict) -> Optional[float]:
    """1 - device busy (the union of the kernels' intervals) over the
    traced slice's length, in %."""
    s = run.get("trace")
    if not s or not s["device_events"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline(run: dict, pattern, bounds: List[float]) -> Optional[float]:
    """The least time of the kernel's calls in the slice over their device
    time, in %.  ``bounds``: each call's least time, in the order the slice
    made them.  Where the profile lost some calls' events, the mean call's
    bound stands for each event found."""
    times = kernels_matching(run.get("trace"), pattern)
    if not times or not bounds:
        return None
    need = (sum(bounds) if len(times) == len(bounds)
            else sum(bounds) / len(bounds) * len(times))
    return 100.0 * need / sum(times)


def k1_bounds(run: dict) -> List[float]:
    """One flash-attention call a layer of each prefill in the slice, over
    the prompt's causal pairs."""
    fam, c = run["family"], run["config"]
    if not hasattr(fam, "k1_work"):
        return []
    b = bound_s(*fam.k1_work(c, run["prompt_len"]))
    n = sum(1 for kind, _ in run.get("slice_steps", ()) if kind == "prefill")
    return [b] * (n * fam.dims(c)["L"])


def k2_bounds(run: dict) -> List[float]:
    """One flash-decode call a layer of each decode step in the slice, over
    the cache rows of the rows then active (each its position plus one)."""
    fam, c = run["family"], run["config"]
    if not hasattr(fam, "k2_work"):
        return []
    out: List[float] = []
    for kind, positions in run.get("slice_steps", ()):
        if kind == "decode" and positions:
            b = bound_s(*fam.k2_work(c, [p + 1 for p in positions]))
            out += [b] * fam.dims(c)["L"]
    return out
