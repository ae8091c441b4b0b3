# Counterpart of src/repro/core/nugget.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Nugget artifacts (paper §III-D): a portable, replayable snippet bounded by
markers, plus warmup region and extrapolation weight.

Adaptation note (DESIGN.md §2): an XLA step is atomic, so replay runs whole
steps and attributes marker-bounded wall time by UoW pro-rating of the two
boundary steps; markers are exact in unit-of-work space.  In "simulation"
(the dry-run/profiler) markers are located by HLO scope label with zero
runtime overhead — the analogue of gem5 PC tracking.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.intervals import Marker, Profile
from repro_torch.core.markers import MarkerPlan, plan_markers
from repro_torch.core.select import Selection


@dataclasses.dataclass
class Nugget:
    nugget_id: int
    interval_idx: int
    weight: float
    plan: MarkerPlan
    # step-space coordinates for the replay engine
    warmup_step: float          # fractional step where warmup starts
    start_step: float
    end_step: float
    uow: float                  # unit-of-work of the measured region
    ckpt_step: int              # nearest checkpointed step <= warmup_step

    def to_json(self) -> Dict:
        return {
            "nugget_id": self.nugget_id,
            "interval_idx": self.interval_idx,
            "weight": self.weight,
            "start": self.plan.start.to_json() if self.plan.start else None,
            "end": self.plan.end.to_json(),
            "warmup_start": (self.plan.warmup_start.to_json()
                             if self.plan.warmup_start else None),
            "hook_fraction": self.plan.hook_fraction,
            "precision_loss_uow": self.plan.precision_loss_uow,
            "warmup_step": self.warmup_step,
            "start_step": self.start_step,
            "end_step": self.end_step,
            "uow": self.uow,
            "ckpt_step": self.ckpt_step,
        }

    @staticmethod
    def from_json(d: Dict) -> "Nugget":
        plan = MarkerPlan(
            Marker.from_json(d["start"]) if d["start"] else None,
            Marker.from_json(d["end"]),
            Marker.from_json(d["warmup_start"]) if d["warmup_start"] else None,
            d["hook_fraction"], d["precision_loss_uow"])
        return Nugget(d["nugget_id"], d["interval_idx"], d["weight"], plan,
                      d["warmup_step"], d["start_step"], d["end_step"],
                      d["uow"], d["ckpt_step"])


def create_nuggets(profile: Profile, selection: Selection, *,
                   warmup_intervals: int = 1,
                   search_distance: float = 0.0,
                   ckpt_every: int = 0) -> List[Nugget]:
    """Paper Fig. 1 'Nugget creation': markers + warmup for each selected
    interval; ``ckpt_every`` aligns replay starts to checkpointed steps."""
    out: List[Nugget] = []
    for nid, (idx, w) in enumerate(zip(selection.interval_ids,
                                       selection.weights)):
        iv = profile.intervals[idx]
        plan = plan_markers(profile, idx, warmup_intervals=warmup_intervals,
                            search_distance=search_distance)
        w_idx = max(0, idx - warmup_intervals)
        warm_step = profile.intervals[w_idx].start_step
        ck = 0
        if ckpt_every > 0:
            ck = int(warm_step // ckpt_every) * ckpt_every
        out.append(Nugget(
            nugget_id=nid, interval_idx=idx, weight=float(w), plan=plan,
            warmup_step=warm_step, start_step=iv.start_step,
            end_step=iv.end_step, uow=iv.end_uow - iv.start_uow,
            ckpt_step=ck))
    return out


def save_nuggets(path: str, nuggets: List[Nugget], selection: Selection):
    with open(path, "w") as f:
        json.dump({"selection": selection.to_json(),
                   "nuggets": [n.to_json() for n in nuggets]}, f, indent=1)


def load_nuggets(path: str):
    with open(path) as f:
        d = json.load(f)
    return ([Nugget.from_json(n) for n in d["nuggets"]],
            Selection.from_json(d["selection"]))
