"""The traced slice: ``torch.profiler`` over a few steady steps, kept in
memory, reduced to device busy time, the kernels by name, and the idle gaps
labelled by what the host was doing.

The profile starts with a few one-element fills that nothing counts: the
profiler at times records a launch with no device event, most often its
first.  The launches made on the host are counted against the device events
recorded, and the shortfall is reported.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

LEAD_IN_LAUNCHES = 8
# host-side CUDA API calls that each put one event on the device
LAUNCH_APIS = ("LaunchKernel", "Memcpy", "Memset")
# host ranges that label an idle gap: the harness's own and the program's
# block labels
LABEL_PREFIXES = ("engine.", "harness.", "nugget_block_")
TOP = 10


def _is_device(e) -> bool:
    return e.device_type().name != "CPU"


def _is_annotation(e) -> bool:
    """A ``record_function`` range, on the host or its span on the device
    (the block labels show on the device's timeline too)."""
    return bool(e.is_user_annotation()) or e.name().startswith(LABEL_PREFIXES)


@contextlib.contextmanager
def traced_slice(cuda: bool):
    """Profile the block; the yielded dict gets ``summary`` when it ends
    (the reduction of `summarize`)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out: dict = {}
    with profile(activities=acts) as prof:
        if cuda:
            lead = torch.zeros(1, device="cuda")
            for _ in range(LEAD_IN_LAUNCHES):
                lead.fill_(0.0)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        yield out
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out["summary"] = summarize(prof, t0_ns, window_s, cuda)


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged intervals, as (start, end)."""
    total, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def _labels(spans, gaps) -> List[str]:
    """The label of each gap (sorted by start): the innermost host range
    open at its start, by one sweep over the ranges sorted by start (ranges
    nest, so the open ones form a stack)."""
    out, stack, j = [], [], 0
    for g0, _ in gaps:
        while j < len(spans) and spans[j][0] <= g0:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        out.append(stack[-1][2] if stack else "outside any range")
    return out


def summarize(prof, t0_ns: int, window_s: float, cuda: bool) -> dict:
    events = prof.profiler.kineto_results.events()
    work, launches, spans = [], 0, []
    for e in events:
        if _is_device(e):
            if _is_annotation(e):
                continue
            work.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        else:
            name = e.name()
            if name.startswith("cu") and any(a in name for a in LAUNCH_APIS):
                launches += 1
            elif _is_annotation(e) and name.startswith(LABEL_PREFIXES):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
    # the lead-in fills are the first device events; they count nowhere
    work.sort()
    lead = [w for w in work[:LEAD_IN_LAUNCHES] if "fill" in w[2].lower()
            or "Memset" in w[2]]
    work = work[len(lead):]
    if cuda:
        launches = max(0, launches - LEAD_IN_LAUNCHES)
    busy_ns, gaps = _union([(s, e) for s, e, _ in work])
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in work:
        by_name[name] += (e - s) * 1e-9
    spans.sort()
    idle: Dict[str, float] = collections.defaultdict(float)
    if work:
        # the slice's start and end are idle too where no kernel ran
        lo, hi = work[0][0], max(e for _, e, _ in work)
        edges = [(t0_ns, lo)] if lo > t0_ns else []
        end_ns = t0_ns + int(window_s * 1e9)
        if end_ns > hi:
            edges.append((hi, end_ns))
        gaps = sorted(gaps + edges)
        for (g0, g1), label in zip(gaps, _labels(spans, gaps)):
            idle[label] += (g1 - g0) * 1e-9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": window_s,
        "device_events": len(work),
        "host_launches": launches,
        "lost_device_events": max(0, launches - len(work)),
        "kernels": [(name, (e - s) * 1e-9) for s, e, name in work],
        "breakdown": {"device_ops": [[k[:160], v] for k, v in top_ops],
                      "idle_gaps": [[k, v] for k, v in top_idle]},
    }


def kernels_matching(summary: Optional[dict], pattern) -> List[float]:
    """Durations (s) of the slice's device events whose name matches."""
    if not summary:
        return []
    return [d for name, d in summary["kernels"] if pattern.search(name)]
