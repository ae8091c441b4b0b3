# Counterpart of src/repro/pipeline/scheduler.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Concurrent DAG executor for the stage graph.

``run_dag`` drives a dependency graph of named nodes through a thread
pool: every node whose dependencies are complete is submitted
immediately, so independent branches (per-platform baselines and
replays, profile vs. baseline) overlap instead of serializing.  The
executor is deliberately generic — nodes are names, dependencies are
name lists, and the work is an opaque ``run(name)`` callable — so the
pipeline runtime stays the single place that knows what a stage *is*.

Scheduling is deterministic: ready nodes are submitted in declaration
order, so with ``max_workers=1`` (or ``0``) execution degrades to
exactly the legacy serial loop.  Worker threads tag themselves into the
process tracer (``obs.set_worker``) before running a node, so every
span a stage emits carries the worker id and ``repro_torch.launch.obs``
merge/export renders the parallel timeline as named tracks.

Fault tolerance (``repro_torch.faults`` vocabulary):

- **Retries** — with a :class:`~repro_torch.faults.RetryPolicy`, a node
  attempt that fails with a *transient* error (``classify``) is retried
  up to ``max_attempts`` times with exponential backoff and
  deterministic jitter; retry/timeout events land in the obs trace
  (``stage.retry`` / ``stage.timeout``) and metrics
  (``pipeline.retries`` / ``pipeline.timeouts``).  Fatal errors
  propagate on the first attempt, exactly like the no-policy path.
- **Timeouts** — ``RetryPolicy.timeout_s`` bounds each attempt's wall
  clock: the attempt runs on a watchdog thread and a breach raises
  :class:`~repro_torch.faults.StageTimeout` (transient, so it retries).  The
  stalled attempt is abandoned (daemon thread); because the store's
  commit is idempotent and keyed, a zombie attempt that eventually
  finishes is harmless.
- **Worker-death fallback** — a node that dies with
  :class:`~repro_torch.faults.WorkerKilled` is rescheduled; after
  ``serial_fallback_after`` deaths the pool is drained and the
  remaining graph finishes on the caller's thread (the legacy serial
  loop), logging the downgrade (``scheduler.fallback_serial``) — the
  run completes rather than flaking.

Other failure semantics are unchanged: the first fatal node exception
propagates to the caller; nodes already running finish, nothing new is
scheduled, queued-but-unstarted futures are cancelled; a dependency
cycle raises instead of deadlocking.  ``run_dag`` returns a stats dict
(``retries`` / ``timeouts`` / ``worker_failures`` / ``fallback_serial``)
that the pipeline manifest surfaces.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Set

from repro_torch import obs
from repro_torch.faults import RetryPolicy, StageTimeout, WorkerKilled, classify


def run_dag(order: Sequence[str], deps: Mapping[str, Sequence[str]],
            run: Callable[[str], None], *, max_workers: int = 0,
            thread_name_prefix: str = "worker",
            retry: Optional[RetryPolicy] = None,
            serial_fallback_after: int = 2) -> Dict[str, Any]:
    """Execute every node of a dependency graph, concurrently when possible.

    ``order`` lists all nodes (and fixes the tie-break: among ready nodes,
    earlier declaration runs/submits first).  ``deps[name]`` names the
    nodes that must complete before ``name`` may start.  ``run(name)``
    performs the work; its fatal exceptions propagate.  ``max_workers <=
    1`` runs serially on the calling thread — no pool, no worker tags —
    which keeps the serial path byte-identical to the legacy loop.

    ``retry`` enables transient-error retries and per-attempt timeouts
    (see module docstring); ``serial_fallback_after`` is the number of
    ``WorkerKilled`` casualties after which the remaining graph degrades
    to the serial loop.  Returns the run's fault-tolerance stats.

    Raises ``ValueError`` for unknown/duplicate nodes and ``RuntimeError``
    when the graph has a cycle (detected, not deadlocked).
    """
    names = list(order)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate node names in {names!r}")
    known = set(names)
    waiting: Dict[str, Set[str]] = {}
    for n in names:
        ds = set(deps.get(n, ()))
        unknown = ds - known
        if unknown:
            raise ValueError(f"node {n!r} depends on unknown {sorted(unknown)}")
        waiting[n] = ds

    stats: Dict[str, Any] = {"retries": 0, "timeouts": 0,
                             "worker_failures": 0, "fallback_serial": False}
    stats_lock = threading.Lock()

    if max_workers <= 1:
        _run_serial(names, waiting, run, retry, stats, stats_lock)
        return stats

    alldeps = {n: set(deps.get(n, ())) for n in names}
    completed: Set[str] = set()
    futs: Dict[cf.Future, str] = {}
    degraded = False
    with cf.ThreadPoolExecutor(max_workers=max_workers,
                               thread_name_prefix=thread_name_prefix) as ex:
        try:
            while waiting or futs:
                ready = [n for n in names
                         if n in waiting and waiting[n] <= completed]
                for n in ready:
                    del waiting[n]
                    futs[ex.submit(_tagged, run, n, retry,
                                   stats, stats_lock)] = n
                if not futs:
                    raise RuntimeError(
                        f"dependency cycle among {sorted(waiting)}")
                done, _ = cf.wait(futs, return_when=cf.FIRST_COMPLETED)
                for f in done:
                    name = futs.pop(f)
                    if _completed_or_requeue(f, name, alldeps, waiting,
                                             stats, stats_lock):
                        completed.add(name)
                    elif stats["worker_failures"] >= serial_fallback_after:
                        degraded = True
                if degraded:
                    # drain in-flight nodes, requeueing further casualties
                    for f, name in list(futs.items()):
                        if _completed_or_requeue(f, name, alldeps, waiting,
                                                 stats, stats_lock):
                            completed.add(name)
                    futs.clear()
                    break
        finally:
            for f in futs:              # queued-but-unstarted work
                f.cancel()
    if degraded and waiting:
        stats["fallback_serial"] = True
        obs.metrics().count("scheduler.fallback_serial")
        obs.event("scheduler.fallback_serial",
                  remaining=len(waiting),
                  worker_failures=stats["worker_failures"])
        obs.log.kv("scheduler_degraded", logger="scheduler",
                   worker_failures=stats["worker_failures"],
                   remaining=sorted(waiting))
        _run_serial(names, waiting, run, retry, stats, stats_lock,
                    completed=completed)
    return stats


def _completed_or_requeue(fut: cf.Future, name: str,
                          alldeps: Mapping[str, Set[str]],
                          waiting: Dict[str, Set[str]],
                          stats: Dict[str, Any],
                          stats_lock: threading.Lock) -> bool:
    """Resolve one finished future: True when the node completed; a
    ``WorkerKilled`` casualty is counted and the node requeued (False);
    any other exception re-raises."""
    try:
        fut.result()
        return True
    except WorkerKilled:
        with stats_lock:
            stats["worker_failures"] += 1
        obs.metrics().count("scheduler.worker_failures")
        obs.event("scheduler.worker_killed", stage=name)
        obs.log.kv("worker_killed", logger="scheduler", stage=name,
                   failures=stats["worker_failures"])
        waiting[name] = set(alldeps[name])
        return False


def _run_serial(names: Sequence[str], waiting: Dict[str, Set[str]],
                run: Callable[[str], None],
                retry: Optional[RetryPolicy] = None,
                stats: Optional[Dict[str, Any]] = None,
                stats_lock: Optional[threading.Lock] = None,
                completed: Optional[Set[str]] = None) -> None:
    completed = set() if completed is None else completed
    while waiting:
        ready = [n for n in names if n in waiting and waiting[n] <= completed]
        if not ready:
            raise RuntimeError(f"dependency cycle among {sorted(waiting)}")
        for n in ready:
            del waiting[n]
            _attempt(run, n, retry, stats, stats_lock, in_worker=False)
            completed.add(n)


def _tagged(run: Callable[[str], None], name: str,
            retry: Optional[RetryPolicy], stats: Optional[Dict[str, Any]],
            stats_lock: Optional[threading.Lock]) -> None:
    """Run one node with the pool thread's worker id on the tracer, so
    every span the node emits is attributable to its worker track."""
    obs.set_worker(threading.current_thread().name)
    _attempt(run, name, retry, stats, stats_lock, in_worker=True)


def _attempt(run: Callable[[str], None], name: str,
             retry: Optional[RetryPolicy], stats: Optional[Dict[str, Any]],
             stats_lock: Optional[threading.Lock], *,
             in_worker: bool) -> None:
    """Drive one node through the retry policy.  ``WorkerKilled`` in a
    pool worker propagates immediately (the scheduler loop reschedules
    the node / degrades to serial); on the caller thread there is no
    worker to lose, so it retries like any transient error."""
    if retry is None:
        run(name)
        return
    attempt = 1
    while True:
        try:
            _bounded(run, name, retry.timeout_s, stats, stats_lock)
            return
        except Exception as e:
            if isinstance(e, WorkerKilled) and in_worker:
                raise
            if classify(e) != "transient" or attempt >= retry.max_attempts:
                raise
            delay = retry.delay(name, attempt)
            if stats_lock is not None:
                with stats_lock:
                    stats["retries"] += 1
            obs.metrics().count("pipeline.retries")
            obs.event("stage.retry", stage=name, attempt=attempt,
                      error=type(e).__name__, delay_s=round(delay, 4))
            obs.log.kv("stage_retry", logger="scheduler", stage=name,
                       attempt=attempt, error=type(e).__name__,
                       delay_s=round(delay, 4))
            time.sleep(delay)
            attempt += 1


def _bounded(run: Callable[[str], None], name: str,
             timeout_s: Optional[float], stats: Optional[Dict[str, Any]],
             stats_lock: Optional[threading.Lock]) -> None:
    """Run one attempt, bounded by ``timeout_s`` on a watchdog thread.
    A breach abandons the attempt (daemon thread) and raises
    ``StageTimeout``; without a timeout the attempt runs inline."""
    if not timeout_s:
        run(name)
        return
    box: Dict[str, Any] = {}
    worker = obs.tracer().worker()

    def target():
        if worker is not None:
            obs.set_worker(worker)
        try:
            run(name)
        except BaseException as e:      # noqa: BLE001 - relayed below
            box["exc"] = e

    th = threading.Thread(target=target, name=f"attempt-{name}", daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        if stats_lock is not None:
            with stats_lock:
                stats["timeouts"] += 1
        obs.metrics().count("pipeline.timeouts")
        obs.event("stage.timeout", stage=name, timeout_s=timeout_s)
        obs.log.kv("stage_timeout", logger="scheduler", stage=name,
                   timeout_s=timeout_s)
        raise StageTimeout(f"stage {name!r} exceeded its "
                           f"{timeout_s}s wall-clock budget")
    if "exc" in box:
        raise box["exc"]
