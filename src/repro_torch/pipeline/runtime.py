# Counterpart of src/repro/pipeline/runtime.py; nothing of it is left
# unported.  It differs from the reference where the port differs: the base
# config trains on the chunked attention and SSD (the port's configs default
# to the CUDA kernels, which have no backward), each platform's spec names
# the backend and the device (so a store shared with the JAX package, or
# between the CPU and the card, never serves one's artifact to the other), the
# run's device is a config field, and `Trainer` has no `donate` switch.
"""Pipeline orchestration: config, context (lazy per-platform trainers),
stage graph and the JSON run manifest.

A *platform* is named by a token parsed into config overrides, e.g.
``f32``, ``bf16-chunk16``, ``f32-ref`` — the same dtype/impl axes the
benchmarks use as stand-ins for distinct machines.  The profile is taken
on ``profile_platform`` (default: the first platform); replay + baseline
run on every platform; validation summarizes across them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ArchConfig, config_dict
from repro_torch.device import resolve_device
from repro_torch.faults import FaultInjector, RetryPolicy
from repro_torch.pipeline.journal import RunJournal
from repro_torch.pipeline.scheduler import run_dag
from repro_torch.pipeline.stages import (BaselineStage, MarkStage, ProfileStage,
                                   ReplayStage, SelectStage, Stage,
                                   ValidateStage)
from repro_torch.pipeline.store import (ARTIFACT_KINDS, Artifact, ArtifactStore,
                                  canonical_json)


def platform_config(base: ArchConfig, token: str) -> ArchConfig:
    """Apply a platform token's overrides: dash-separated parts out of
    {f32, bf16, f16, ref, chunk<N>} (e.g. ``bf16-chunk16``, ``f32-ref``)."""
    changes: Dict[str, Any] = {}
    for part in token.split("-"):
        if part in ("f32", "fp32", "float32"):
            changes["compute_dtype"] = "float32"
        elif part in ("bf16", "bfloat16"):
            changes["compute_dtype"] = "bfloat16"
        elif part in ("f16", "float16"):
            changes["compute_dtype"] = "float16"
        elif part == "ref":
            changes["attention_impl"] = "reference"
        elif part.startswith("chunk"):
            changes["attn_chunk"] = int(part[len("chunk"):])
        else:
            raise ValueError(f"unknown platform token part {part!r} "
                             f"in {token!r}")
    return dataclasses.replace(base, **changes)


# PipelineConfig fields that shape execution, not results: excluded from
# stage specs (artifact keys) and the journal run key
EXEC_FIELDS = frozenset({"workers", "max_attempts", "retry_backoff_s",
                         "stage_timeout_s", "gc_orphans"})


@dataclasses.dataclass
class PipelineConfig:
    arch: str
    platforms: Sequence[str] = ("f32", "bf16")
    selector: str = "kmeans"
    selector_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    steps: int = 32
    seq_len: int = 32
    batch: int = 4
    interval_steps: float = 2.5
    seed: int = 0
    reduce: bool = True
    warmup_intervals: int = 1
    search_distance: float = 0.0
    ckpt_every: int = 0
    defer_analysis: bool = True          # batch (vectorized) interval analysis
    profile_platform: Optional[str] = None   # default: platforms[0]
    # where trainers run ("cuda" or "cpu"); part of every platform spec,
    # since it changes what baseline and replay measure
    device: str = "cuda"
    # -- execution-only knobs (EXEC_FIELDS): how the run executes, never
    # what it computes.  Excluded from every stage spec AND from the run
    # journal key, so serial/parallel/retried runs share artifact keys
    # and resume each other's journals.
    # stage-scheduler worker threads: 0/1 = the legacy serial loop, N>1 =
    # concurrent DAG execution + sharded profile finalize.
    workers: int = 0
    # stage retry policy (see repro_torch.faults.RetryPolicy): transient
    # failures retry with exponential backoff + deterministic jitter;
    # stage_timeout_s bounds each attempt's wall clock (None = no bound)
    max_attempts: int = 3
    retry_backoff_s: float = 0.05
    stage_timeout_s: Optional[float] = None
    # remove orphaned (uncommitted) artifact dirs at run start — crash
    # debris from a SIGKILL'd run; disable when other pipelines may be
    # computing into the same store concurrently
    gc_orphans: bool = True

    @property
    def profile_platform_name(self) -> str:
        return self.profile_platform or self.platforms[0]

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(max_attempts=self.max_attempts,
                           backoff_s=self.retry_backoff_s,
                           timeout_s=self.stage_timeout_s)

    def run_key(self) -> str:
        """Digest identifying the *logical* run (everything except the
        EXEC_FIELDS) — names the journal file, so a crashed serial run
        and its parallel rerun append to the same history."""
        doc = {k: v for k, v in dataclasses.asdict(self).items()
               if k not in EXEC_FIELDS}
        return hashlib.sha256(canonical_json(doc).encode()).hexdigest()[:16]

    def base_cfg(self) -> ArchConfig:
        cfg = get_config(self.arch)
        cfg = reduced(cfg, seq=self.seq_len) if self.reduce else cfg
        # the reference's default impls: the trainers cannot take "cuda"
        return dataclasses.replace(cfg, attention_impl="chunked",
                                   ssm_impl="chunked")

    def arch_for(self, platform: str) -> ArchConfig:
        return platform_config(self.base_cfg(), platform)

    def platform_spec(self, platform: str) -> Dict:
        """Everything a platform run depends on (part of stage specs)."""
        return {"arch": config_dict(self.arch_for(platform)),
                "platform": platform, "seq_len": self.seq_len,
                "batch": self.batch, "seed": self.seed,
                "backend": "torch", "device": self.device}


class PipelineContext:
    """Per-run state stages see: config, store, produced artifacts/payloads,
    manifest entries, and lazily constructed per-platform trainers (a cache
    hit upstream means the corresponding trainer is never even built).

    Thread-safe: the DAG scheduler runs stages concurrently, so artifact
    and manifest recording take a context lock and trainer construction is
    serialized per platform (two platforms build concurrently; two stages
    of one platform share a single build)."""

    def __init__(self, cfg: PipelineConfig, store: ArtifactStore,
                 workers: int = 0, journal: Optional[RunJournal] = None):
        self.cfg = cfg
        self.store = store
        self.workers = workers
        self.journal = journal
        self.artifacts: Dict[str, Artifact] = {}
        self.payloads: Dict[str, Any] = {}
        self.manifest: List[Dict] = []
        self._trainers: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._trainer_locks: Dict[str, threading.Lock] = {}

    def journal_event(self, kind: str, **fields: Any) -> None:
        """Append one lifecycle event to the run journal (no-op when the
        run is not journaled — e.g. bare Stage.run in tests)."""
        if self.journal is not None:
            self.journal.append(kind, **fields)

    # -- artifact accessors (stage name -> product) --------------------
    def key(self, name: str) -> str:
        return self.artifacts[name].key

    def payload(self, name: str) -> Any:
        return self.payloads[name]

    def record(self, stage: Stage, art: Artifact, payload: Any,
               hit: bool, wall_s: float) -> None:
        with self._lock:
            self.artifacts[stage.name] = art
            self.payloads[stage.name] = payload
            self.manifest.append({"stage": stage.name, "kind": stage.kind,
                                  "key": art.key, "cache_hit": hit,
                                  "wall_s": wall_s, "path": art.path})

    # -- platforms -----------------------------------------------------
    def trainer(self, platform: str):
        """Lazy Trainer per platform.  Only the profile platform is
        instrumented; replay/baseline platforms use the plain step fn."""
        with self._lock:
            tr = self._trainers.get(platform)
            if tr is not None:
                return tr
            lock = self._trainer_locks.setdefault(platform, threading.Lock())
        with lock:
            if platform not in self._trainers:
                from repro_torch.train import Trainer
                cfg = self.cfg
                tr = Trainer(
                    cfg.arch_for(platform), seq_len=cfg.seq_len,
                    batch=cfg.batch, interval_steps=cfg.interval_steps,
                    seed=cfg.seed,
                    instrument=(platform == cfg.profile_platform_name),
                    defer_analysis=cfg.defer_analysis, device=cfg.device)
                with self._lock:
                    self._trainers[platform] = tr
        return self._trainers[platform]

    def runner(self, platform: str):
        return self.trainer(platform).make_runner()


class Pipeline:
    """The end-to-end nugget lifecycle as a resumable stage graph."""

    def __init__(self, cfg: PipelineConfig,
                 store: Union[str, ArtifactStore],
                 fault_injector: Optional[FaultInjector] = None):
        resolve_device(cfg.device)        # no card and not asked for the CPU
        self.cfg = cfg
        self.store = (store if isinstance(store, ArtifactStore)
                      else ArtifactStore(store, injector=fault_injector))
        self.injector = fault_injector
        if fault_injector is not None:
            # an injected store also corrupts payloads post-commit
            self.store.injector = fault_injector

    def stages(self) -> List[Stage]:
        out: List[Stage] = [ProfileStage(), SelectStage(), MarkStage()]
        for p in self.cfg.platforms:
            out.append(BaselineStage(p))
        for p in self.cfg.platforms:
            out.append(ReplayStage(p))
        out.append(ValidateStage())
        return out

    def run(self, workers: Optional[int] = None) -> Dict:
        """Run every stage (cache-aware) and return the run manifest.

        With ``workers > 1`` (argument, else ``cfg.workers``) the stage
        graph executes on a concurrent DAG scheduler: every stage whose
        dependencies are complete runs immediately on a worker thread, so
        per-platform baselines/replays and the profile overlap instead of
        serializing.  Stage identity is unaffected — artifact keys, stage
        payloads and the manifest's stage order are identical to a serial
        run; only wall time (and the worker tags on trace spans) differ.

        The manifest embeds an ``obs`` block: the process metrics snapshot
        (store hit/miss/bytes, per-stage wall-time histograms, trainer and
        analyzer metrics) plus whether tracing was live for the run.

        Fault tolerance (see ``docs/robustness.md``): orphaned
        uncommitted artifact dirs are gc'd at run start, every stage
        start/commit is journaled (fsync'd JSONL under
        ``<store>/.journal/``), transient stage failures retry per
        ``cfg.retry_policy()``, and the manifest's ``fault_tolerance``
        block reports retries/timeouts/worker failures/quarantines plus
        the stages a crashed predecessor had already committed
        (``resumed_stages``).
        """
        cfg = self.cfg
        n_workers = cfg.workers if workers is None else workers
        stages = self.stages()
        order = [s.name for s in stages]
        by_name = {s.name: s for s in stages}
        gc_removed = self.store.gc() if cfg.gc_orphans else []
        journal_path = os.path.join(self.store.root, ".journal",
                                    f"run-{cfg.run_key()}.jsonl")
        prior = RunJournal.committed(RunJournal.read(journal_path))
        journal = RunJournal(journal_path)
        ctx = PipelineContext(cfg, self.store, workers=n_workers,
                              journal=journal)
        deps = {s.name: s.deps(ctx) for s in stages}
        injector = self.injector

        def node(name: str) -> None:
            if injector is not None:
                injector.fire("stage", name)
            by_name[name].run(ctx)

        t0 = time.perf_counter()
        journal.append("run_start", pid=os.getpid(), arch=cfg.arch,
                       workers=n_workers, prior_commits=len(prior))
        try:
            with obs.span("pipeline.run", arch=cfg.arch,
                          platforms=list(cfg.platforms),
                          selector=cfg.selector, workers=n_workers):
                stats = run_dag(order, deps, node, max_workers=n_workers,
                                thread_name_prefix="pipe",
                                retry=cfg.retry_policy())
        except BaseException as e:
            journal.append("run_end", status="error",
                           error=type(e).__name__)
            journal.close()
            raise
        journal.append("run_end", status="ok")
        journal.close()
        # stages record completion concurrently; report them in graph
        # declaration order so serial and parallel manifests are comparable
        entries = {e["stage"]: e for e in ctx.manifest}
        manifest = [entries[name] for name in order]
        hits = sum(1 for s in manifest if s["cache_hit"])
        orphans = {k: len(self.store.orphans(k)) for k in ARTIFACT_KINDS}
        return {
            "config": dataclasses.asdict(cfg),
            "store": self.store.root,
            "workers": n_workers,
            "stages": manifest,
            "metrics": ctx.payload("validate"),
            "cache_hits": hits,
            "cache_misses": len(manifest) - hits,
            "wall_s": time.perf_counter() - t0,
            "fault_tolerance": {
                "retries": stats["retries"],
                "timeouts": stats["timeouts"],
                "worker_failures": stats["worker_failures"],
                "fallback_serial": stats["fallback_serial"],
                "quarantined": self.store.counters["quarantined"],
                "journal": journal_path,
                "resumed_stages": sorted(prior),
                "orphans_removed": gc_removed,
                "orphans": {k: n for k, n in orphans.items() if n},
                "faults": (injector.summary()
                           if injector is not None else None),
            },
            "obs": {"traced": obs.enabled(),
                    "store_counters": dict(self.store.counters),
                    "metrics": obs.metrics().snapshot()},
        }
