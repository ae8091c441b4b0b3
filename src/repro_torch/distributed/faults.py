# Counterpart of src/repro/distributed/faults.py: a verbatim copy (stdlib only)
# with the package renamed in its imports; nothing of it is left unported.
"""Failure-injection / heartbeat coordination harness (single-process
simulation of the multi-worker control plane; the same state machine runs
per-host against a distributed KV store in production).

Models the fleet behaviors the framework must survive at 1000+ nodes:
- missed heartbeats -> worker declared dead -> run restarts from the last
  committed checkpoint (tested in tests/test_fault_tolerance.py),
- straggling workers -> logged + (optionally) excluded at the next elastic
  rescale,
- elastic rescale -> new mesh, checkpoint resharded on restore.

Shares the framework failure vocabulary (``repro_torch.faults``) with the
pipeline scheduler/store: event records come from ``fault_event`` and a
step function that dies with :class:`~repro_torch.faults.WorkerKilled` (e.g.
raised by a :class:`~repro_torch.faults.FaultInjector` ``kill`` rule) triggers
the same restart-from-checkpoint path as a scheduled kill point — the
heartbeat/restart state machine and the artifact pipeline speak one
failure language.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.faults import WorkerKilled, fault_event


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float
    step: int = 0
    alive: bool = True
    slow_strikes: int = 0


class HeartbeatCoordinator:
    def __init__(self, n_workers: int, *, timeout_s: float = 1.0,
                 straggler_factor: float = 3.0):
        self.timeout = timeout_s
        self.straggler_factor = straggler_factor
        now = time.monotonic()
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(i, now) for i in range(n_workers)}
        self.events: List[Dict] = []
        # per-instance step-time window: straggler medians must never
        # leak between coordinators (or between tests)
        self._times: List[float] = []
        self._lock = threading.Lock()

    def heartbeat(self, worker_id: int, step: int,
                  step_time_s: Optional[float] = None) -> None:
        with self._lock:
            w = self.workers[worker_id]
            w.last_heartbeat = time.monotonic()
            w.step = step
            if step_time_s is not None:
                med = self._median_step_time(step_time_s)
                if step_time_s > self.straggler_factor * med:
                    w.slow_strikes += 1
                    self.events.append(fault_event(
                        "straggler", worker=worker_id, step=step,
                        t=step_time_s))

    def _median_step_time(self, t: float) -> float:
        self._times.append(t)
        s = sorted(self._times[-100:])
        return s[len(s) // 2]

    def check(self) -> List[int]:
        """Returns newly-dead worker ids (missed heartbeat past timeout)."""
        now = time.monotonic()
        dead = []
        with self._lock:
            for w in self.workers.values():
                if w.alive and now - w.last_heartbeat > self.timeout:
                    w.alive = False
                    dead.append(w.worker_id)
                    self.events.append(fault_event(
                        "dead", worker=w.worker_id, step=w.step))
        return dead

    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for w in self.workers.values() if w.alive)

    def min_committed_step(self) -> int:
        with self._lock:
            alive = [w.step for w in self.workers.values() if w.alive]
        return min(alive) if alive else 0


class FaultInjectingRun:
    """Drives a step function across simulated workers, killing some at
    scheduled steps; on death the run restarts every worker from the last
    checkpoint — asserts end-state equivalence with an uninterrupted run."""

    def __init__(self, n_workers: int, run_steps: Callable[[int, int], int],
                 *, ckpt_every: int, kill_at: Dict[int, int]):
        # run_steps(from_step, to_step) -> last completed step, raises on kill
        self.n_workers = n_workers
        self.run_steps = run_steps
        self.ckpt_every = ckpt_every
        self.kill_at = dict(kill_at)
        self.restarts = 0
        self.events: List[Dict] = []

    def run(self, total_steps: int) -> int:
        step = 0
        while step < total_steps:
            kill_points = sorted(s for s in self.kill_at.values()
                                 if s > step)
            target = min([total_steps] + kill_points)
            killed = False
            try:
                step = self.run_steps(step, target)
            except WorkerKilled as e:
                # a step function sharing the pipeline failure vocabulary
                # (e.g. a FaultInjector kill rule) died mid-range: same
                # restart-from-checkpoint path as a scheduled kill point
                killed = True
                self.events.append(fault_event("worker_killed", step=step,
                                               detail=str(e)))
            if step < total_steps and (
                    killed or (kill_points and step >= kill_points[0] - 1)):
                # simulate crash: roll back to last committed checkpoint
                self.restarts += 1
                step = (step // self.ckpt_every) * self.ckpt_every
                self.kill_at = {w: s for w, s in self.kill_at.items()
                                if s > target}
        return step
