# Counterpart of src/repro/core/replay.py; nothing of it is left unported.
# `SimpleRunner.sync` defaults to `sync_device` (the card's synchronise) where
# the reference blocks on a JAX array.
"""Nugget replay engine (paper §III-E + §V-A experimental setup).

A *platform* is anything that can run steps: a StepRunner wraps (step_fn,
state-reset) so the same nuggets validate across dtype / impl platforms.
Replay:

1. position at the nugget's checkpoint step (``runner.reset``),
2. fast-forward to the warmup marker (untimed — KVM-fast-forward analogue),
3. run warmup steps (microarchitectural-state warmup analogue: here it warms
   the allocator's pools and host caches),
4. time the marker-bounded region; boundary steps are pro-rated by UoW.

``measure_full_run`` times a whole workload on one platform, the ground
truth that replayed nuggets are held against.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Protocol

import torch

from repro_torch import obs
from repro_torch.core.intervals import Profile
from repro_torch.core.nugget import Nugget


class StepRunner(Protocol):
    def reset(self, step: int) -> Any: ...
    def run_step(self, state: Any, step: int) -> Any: ...
    def sync(self, state: Any) -> None: ...


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def sync_device(state: Any) -> None:
    """Wait for the card's work on ``state`` (nothing to wait for on the
    CPU, where every op has returned when it has run)."""
    t = _first_tensor(state)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class SimpleRunner:
    """Wraps a step closure + reset for replay."""
    reset_fn: Callable[[int], Any]
    step_fn: Callable[[Any, int], Any]
    sync_fn: Optional[Callable[[Any], None]] = None

    def reset(self, step: int) -> Any:
        return self.reset_fn(step)

    def run_step(self, state: Any, step: int) -> Any:
        return self.step_fn(state, step)

    def sync(self, state: Any) -> None:
        (self.sync_fn or sync_device)(state)


@dataclasses.dataclass
class ReplayResult:
    nugget_id: int
    interval_idx: int
    weight: float
    region_time_s: float        # marker-bounded, UoW-pro-rated
    steps_timed: int
    warmup_steps: int
    uow: float

    def to_json(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "ReplayResult":
        return ReplayResult(int(d["nugget_id"]), int(d["interval_idx"]),
                            float(d["weight"]), float(d["region_time_s"]),
                            int(d["steps_timed"]), int(d["warmup_steps"]),
                            float(d["uow"]))


class ReplayEngine:
    def __init__(self, runner: StepRunner, profile: Profile):
        self.runner = runner
        self.profile = profile
        self._compiled = False

    def warm_compile(self) -> None:
        """Throwaway step so the first nugget's timed region never includes
        first-call set-up.  Eager PyTorch compiles nothing (the reference
        warms jit here); what the first step pays for is the cuBLAS handle,
        kernel loading and the caching allocator's first pools."""
        if self._compiled:
            return
        state = self.runner.reset(0)
        state = self.runner.run_step(state, 0)
        self.runner.sync(state)
        self._compiled = True

    def replay(self, nugget: Nugget) -> ReplayResult:
        with obs.span("replay.nugget", nugget=nugget.nugget_id,
                      interval=nugget.interval_idx):
            result = self._replay(nugget)
        m = obs.metrics()
        m.count("replay.nuggets")
        m.observe("replay.region_s", result.region_time_s)
        return result

    def _replay(self, nugget: Nugget) -> ReplayResult:
        self.warm_compile()
        first_step = int(math.floor(nugget.start_step))
        last_step = int(math.ceil(nugget.end_step)) - 1
        warm_first = int(math.floor(nugget.warmup_step))

        # the engine keeps no state between nuggets (warm_compile's and the
        # previous nugget's were dropped when their calls returned), so this
        # reset is the only train state alive
        state = self.runner.reset(nugget.ckpt_step)
        step = nugget.ckpt_step
        # fast-forward (untimed) to warmup start, then warmup (executed,
        # untimed — the microarchitectural-warmup analogue)
        while step < first_step:
            state = self.runner.run_step(state, step)
            step += 1
        self.runner.sync(state)
        # timed region: ONE sync pair around the whole region so async
        # dispatch pipelines exactly as in the full-run ground truth;
        # boundary steps are pro-rated by their UoW overlap.
        n_steps = last_step - first_step + 1
        t0 = time.perf_counter()
        while step <= last_step:
            state = self.runner.run_step(state, step)
            step += 1
        self.runner.sync(state)
        total = time.perf_counter() - t0
        overlap = 0.0
        for i in range(n_steps):
            s = first_step + i
            lo = max(nugget.start_step, s)
            hi = min(nugget.end_step, s + 1)
            overlap += max(0.0, hi - lo)
        region = total * (overlap / max(n_steps, 1))
        return ReplayResult(nugget.nugget_id, nugget.interval_idx,
                            nugget.weight, region, n_steps,
                            first_step - warm_first, nugget.uow)

    def replay_all(self, nuggets: List[Nugget]) -> List[ReplayResult]:
        return [self.replay(n) for n in nuggets]


def measure_full_run(runner: StepRunner, n_steps: int,
                     *, start: int = 0) -> float:
    """Ground truth: wall time of the entire workload (paper §II-C).
    One throwaway step first so first-call set-up (the cuBLAS handle, kernel
    loading) never pollutes the measurement.  The throwaway state is dropped
    before the second reset, so two states never live at once (at full width
    a train state is tens of GB)."""
    state = runner.reset(start)
    state = runner.run_step(state, start)
    runner.sync(state)
    state = None
    state = runner.reset(start)
    t0 = time.perf_counter()
    for s in range(start, n_steps):
        state = runner.run_step(state, s)
    runner.sync(state)
    return time.perf_counter() - t0
