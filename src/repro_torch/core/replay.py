# Counterpart of src/repro/core/replay.py.  Not ported yet: `ReplayEngine`
# and `ReplayResult`, which replay nuggets and come with the pipeline slice
# (with `core/nugget.py`, `markers`, `select` and `kmeans`).
"""Step runners of the replay engine (paper §III-E + §V-A experimental setup).

A *platform* is anything that can run steps: a StepRunner wraps (step_fn,
state-reset) so the same nuggets validate across dtype / impl platforms.
``measure_full_run`` times a whole workload on one, the ground truth that
replayed nuggets are held against.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Protocol

import torch


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


def measure_full_run(runner: StepRunner, n_steps: int,
                     *, start: int = 0) -> float:
    """Ground truth: wall time of the entire workload (paper §II-C).
    One throwaway step first so first-call set-up (the cuBLAS handle, kernel
    loading) never pollutes the measurement."""
    state = runner.reset(start)
    state = runner.run_step(state, start)
    runner.sync(state)
    state = runner.reset(start)
    t0 = time.perf_counter()
    for s in range(start, n_steps):
        state = runner.run_step(state, s)
    runner.sync(state)
    return time.perf_counter() - t0
