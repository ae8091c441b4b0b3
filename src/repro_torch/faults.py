# Counterpart of src/repro/faults.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.  The
# distributed restart state machine that its docstring names is ported too
# (`repro_torch/distributed/faults.py`).
"""Shared failure vocabulary for the whole framework.

One module defines what a *fault* is, so the pipeline scheduler
(``repro_torch.pipeline.scheduler``), the artifact store
(``repro_torch.pipeline.store``) and the distributed heartbeat/restart state
machine (``repro_torch.distributed.faults``) speak the same language:

- **Exceptions** — :class:`TransientError` subclasses retry;
  everything else is fatal and propagates.  :func:`classify` is the
  single transient-vs-fatal decision point.
- **Events** — :func:`fault_event` builds the uniform event record the
  heartbeat coordinator, the fault injector and the scheduler all
  append to their logs (``{"kind": ..., **fields}``).
- **RetryPolicy** — max attempts, exponential backoff with
  *deterministic* jitter (hash of stage name + attempt, never
  ``random``), and an optional per-attempt wall-clock timeout.
- **FaultInjector** — env/CLI-configurable failure injection
  (raise-in-stage, kill-worker-thread, corrupt-payload,
  stall-past-timeout) threaded through the store and scheduler as the
  test/CI backbone.  Decisions are derived from a seed + call counter
  via sha256, so a given spec replays identically.

Spec grammar (``--faults`` / ``REPRO_FAULTS``)::

    spec   := rule (";" rule)*
    rule   := kind [":" param ("," param)*]
    kind   := "raise" | "fatal" | "kill" | "stall" | "corrupt"
    param  := "stage=" fnmatch-pattern    # fire site filter (default *)
            | "p=" float                  # per-call probability
            | "n=" int                    # firing budget (kill/stall/
                                          #   corrupt default to n=1)
            | "s=" float                  # stall seconds (stall only)

Examples::

    raise:stage=profile,p=0.3            # profile attempt fails 30%
    kill:n=1;corrupt:stage=profile,n=1   # one worker death, one
                                         #   corrupted profile payload
    stall:stage=replay@f32,s=600         # hang the f32 replay (the
                                         #   CI crash-resume SIGKILL knob)
"""
from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch import obs

ENV_FAULTS = "REPRO_FAULTS"
ENV_FAULT_SEED = "REPRO_FAULT_SEED"

FAULT_KINDS = ("raise", "fatal", "kill", "stall", "corrupt")


# -- exceptions ---------------------------------------------------------
class FaultError(Exception):
    """Base for framework-originated failures."""


class TransientError(FaultError):
    """Retryable failure: the operation may succeed if attempted again."""


class InjectedFault(TransientError):
    """A ``raise`` rule fired (transient: the retry loop absorbs it)."""


class InjectedFatal(FaultError):
    """A ``fatal`` rule fired (not retried; aborts the run)."""


class StageTimeout(TransientError):
    """A stage attempt exceeded its wall-clock budget."""


class WorkerKilled(TransientError):
    """A worker thread died mid-stage (``kill`` rule, or a real pool
    casualty).  The scheduler reschedules the stage; repeated deaths
    degrade the run to the serial loop."""


def classify(exc: BaseException) -> str:
    """``"transient"`` (retry) or ``"fatal"`` (propagate).

    Transient: the explicit :class:`TransientError` family plus the
    OS-level errors a shared/remote store can throw under contention
    (``OSError`` covers ``ConnectionError``/``BrokenPipeError``) and
    ``TimeoutError``.  Everything else — assertion failures, value
    errors, injected fatals — is a genuine bug and must surface.
    """
    if isinstance(exc, (TransientError, OSError, TimeoutError)):
        return "transient"
    return "fatal"


# -- events -------------------------------------------------------------
def fault_event(kind: str, **fields: Any) -> Dict[str, Any]:
    """Uniform failure-event record shared by the heartbeat coordinator,
    the fault injector and the scheduler logs."""
    return {"kind": kind, **fields}


# -- retry policy -------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Stage retry semantics driven by the DAG scheduler.

    Attempt ``k`` (1-based) that fails with a transient error sleeps
    ``backoff_s * backoff_factor**(k-1)`` scaled by a deterministic
    jitter in ``[1, 1+jitter_frac)`` derived from the stage name and
    attempt number — no global RNG, so reruns back off identically.
    ``timeout_s`` bounds each attempt's wall clock (None = unbounded).
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    jitter_frac: float = 0.25
    max_backoff_s: float = 30.0
    timeout_s: Optional[float] = None

    def delay(self, key: str, attempt: int) -> float:
        base = min(self.backoff_s * self.backoff_factor ** (attempt - 1),
                   self.max_backoff_s)
        h = hashlib.sha256(f"{key}\x00{attempt}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / 2.0 ** 64
        return base * (1.0 + self.jitter_frac * frac)


# -- injector -----------------------------------------------------------
@dataclasses.dataclass
class FaultRule:
    """One parsed spec rule plus its firing accounting."""

    kind: str
    stage: str = "*"            # fnmatch pattern over the fire site
    p: float = 1.0              # per-call probability
    n: int = -1                 # firing budget (-1 = unlimited)
    s: float = 0.0              # stall seconds
    fired: int = 0
    calls: int = 0


def parse_fault_spec(spec: str) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, params = part.partition(":")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r} "
                             f"(expected one of {FAULT_KINDS})")
        kw: Dict[str, Any] = {}
        for item in params.split(",") if params else []:
            k, eq, v = item.partition("=")
            k, v = k.strip(), v.strip()
            if not eq:
                raise ValueError(f"malformed fault param {item!r} in {spec!r}")
            if k == "stage":
                kw["stage"] = v
            elif k == "p":
                kw["p"] = float(v)
            elif k == "n":
                kw["n"] = int(v)
            elif k == "s":
                kw["s"] = float(v)
            else:
                raise ValueError(f"unknown fault param {k!r} in {spec!r}")
        # destructive one-shot kinds default to a budget of one firing
        if kind in ("kill", "stall", "corrupt", "fatal") and "n" not in kw:
            kw["n"] = 1
        rules.append(FaultRule(kind=kind, **kw))
    return rules


class FaultInjector:
    """Deterministic, spec-driven failure injection.

    The scheduler calls :meth:`fire` before every stage attempt; the
    store calls :meth:`corrupt` after every artifact commit.  Each rule
    keeps its own call counter, and probabilistic decisions hash
    ``(seed, rule, site, call#)`` — so a spec + seed replays the exact
    same failure schedule, retries included (each retry is a fresh
    call and gets a fresh draw).
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        return cls(parse_fault_spec(spec), seed=seed)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> Optional["FaultInjector"]:
        """Build from ``REPRO_FAULTS`` / ``REPRO_FAULT_SEED`` (None when
        unset — the common case costs one dict lookup)."""
        e = os.environ if env is None else env
        spec = e.get(ENV_FAULTS, "").strip()
        if not spec:
            return None
        return cls.from_spec(spec, seed=int(e.get(ENV_FAULT_SEED, "0")))

    # -- decision core -------------------------------------------------
    def _decide(self, idx: int, rule: FaultRule, site: str) -> bool:
        """Under ``self._lock``: consume one call, return whether the
        rule fires (budget + deterministic probability draw)."""
        rule.calls += 1
        if rule.n >= 0 and rule.fired >= rule.n:
            return False
        if rule.p < 1.0:
            h = hashlib.sha256(
                f"{self.seed}\x00{idx}\x00{site}\x00{rule.calls}".encode()
            ).digest()
            if int.from_bytes(h[:8], "big") / 2.0 ** 64 >= rule.p:
                return False
        rule.fired += 1
        return True

    def _record(self, rule: FaultRule, site: str, **extra: Any) -> None:
        ev = fault_event(rule.kind, site=site, call=rule.calls, **extra)
        self.events.append(ev)
        obs.metrics().count(f"faults.{rule.kind}")
        obs.log.kv("fault_injected", logger="faults", kind=rule.kind,
                   site=site, **extra)
        if obs.enabled():
            obs.event("fault.injected", kind=rule.kind, site=site, **extra)

    # -- hook points ---------------------------------------------------
    def fire(self, point: str, site: str) -> None:
        """Scheduler hook, called before each stage attempt.  May sleep
        (``stall``), raise :class:`InjectedFault` / :class:`InjectedFatal`
        (``raise`` / ``fatal``) or :class:`WorkerKilled` (``kill``)."""
        del point  # one fire point today; kept for future store/net hooks
        for idx, rule in enumerate(self.rules):
            if rule.kind == "corrupt":
                continue
            if not fnmatch.fnmatchcase(site, rule.stage):
                continue
            with self._lock:
                fired = self._decide(idx, rule, site)
                if fired:
                    self._record(rule, site)
            if not fired:
                continue
            if rule.kind == "stall":
                time.sleep(rule.s)
            elif rule.kind == "raise":
                raise InjectedFault(f"injected transient failure at {site}")
            elif rule.kind == "fatal":
                raise InjectedFatal(f"injected fatal failure at {site}")
            elif rule.kind == "kill":
                raise WorkerKilled(f"injected worker death at {site}")

    def corrupt(self, dirpath: str, site: str) -> bool:
        """Store hook, called after an artifact commit: flip one byte of
        the first payload file so integrity verification catches it on
        the next cache-hit load.  Returns True if a corruption landed."""
        for idx, rule in enumerate(self.rules):
            if rule.kind != "corrupt":
                continue
            if not fnmatch.fnmatchcase(site, rule.stage):
                continue
            with self._lock:
                if not self._decide(idx, rule, site):
                    continue
                target = None
                for d, _, files in sorted(os.walk(dirpath)):
                    for fn in sorted(files):
                        if fn != "spec.json" and not fn.endswith(".tmp"):
                            target = os.path.join(d, fn)
                            break
                    if target:
                        break
                if target is None:      # nothing to corrupt: refund budget
                    rule.fired -= 1
                    continue
                with open(target, "r+b") as f:
                    first = f.read(1)
                    f.seek(0)
                    f.write(bytes([first[0] ^ 0xFF]) if first else b"\xff")
                self._record(rule, site,
                             file=os.path.relpath(target, dirpath))
            return True
        return False

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [{"kind": r.kind, "stage": r.stage, "p": r.p,
                           "n": r.n, "fired": r.fired, "calls": r.calls}
                          for r in self.rules],
                "events": list(self.events),
            }
