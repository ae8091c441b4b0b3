# Counterpart of src/repro/core/markers.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Marker derivation + low-overhead marker search (paper §III-D1/2).

A marker is (block, required-hit-count): the nugget's hooks fire at the
marker block and trigger when its cumulative execution count reaches the
target — identical semantics to the paper.  The low-overhead search trades
precision for cost: within ``search_distance`` unit-of-work of the interval
end (via the count-stamp vector) pick the least-frequently-executed block
(via the BBV), so the runtime hook fires as rarely as possible (§III-D2:
hook frequency should stay < 10 % single-stream / < 1 % synchronized of
total block executions).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.intervals import Interval, Marker, Profile


def end_marker(profile: Profile, idx: int) -> Marker:
    return profile.intervals[idx].end_marker


def start_marker(profile: Profile, idx: int) -> Optional[Marker]:
    return profile.start_marker(idx)


def low_overhead_marker(profile: Profile, idx: int,
                        search_distance: float) -> Marker:
    """Least-frequent block whose last execution lies within
    ``search_distance`` UoW of the interval end."""
    iv = profile.intervals[idx]
    lo = iv.end_uow - search_distance
    cands = np.nonzero((iv.stamps >= lo) & (iv.stamps >= 0))[0]
    if len(cands) == 0:
        return iv.end_marker
    freqs = iv.bbv[cands]
    best = cands[np.argmin(freqs)]
    return Marker(int(best), int(iv.hits_at_stamp[best]),
                  float(iv.stamps[best]))


def marker_hook_fraction(profile: Profile, marker: Marker,
                         interval_ids: List[int]) -> float:
    """Fraction of all block executions that are marker-hook fires across the
    given intervals (the paper's Fig. 6 normalized hook-execution count)."""
    total = 0.0
    hook = 0.0
    for i in interval_ids:
        iv = profile.intervals[i]
        total += float(iv.bbv.sum())
        hook += float(iv.bbv[marker.block])
    return hook / max(total, 1.0)


def marker_precision_loss(profile: Profile, idx: int, m: Marker) -> float:
    """UoW distance between the chosen marker and the true interval end."""
    return float(profile.intervals[idx].end_uow - m.uow)


@dataclasses.dataclass
class MarkerPlan:
    """Resolved markers for one nugget (paper Fig. 1 'nugget creation')."""
    start: Optional[Marker]          # None = program start
    end: Marker
    warmup_start: Optional[Marker]   # None = no warmup / program start
    hook_fraction: float
    precision_loss_uow: float


def plan_markers(profile: Profile, idx: int, *, warmup_intervals: int = 1,
                 search_distance: float = 0.0) -> MarkerPlan:
    iv = profile.intervals[idx]
    if search_distance > 0:
        end = low_overhead_marker(profile, idx, search_distance)
        loss = marker_precision_loss(profile, idx, end)
    else:
        end = iv.end_marker
        loss = 0.0
    start = profile.start_marker(idx)
    w_idx = idx - warmup_intervals
    warm = (profile.start_marker(w_idx + 1) if w_idx >= 0 else None) \
        if warmup_intervals > 0 else start
    frac = marker_hook_fraction(profile, end, [idx])
    return MarkerPlan(start, end, warm, frac, loss)
