# Counterpart of src/repro/pipeline/stages.py: a copy with the package renamed in its
# imports; nothing of it is left unported.
"""Typed pipeline stages with a uniform ``Stage.run(ctx) -> Artifact``
contract (paper Fig. 1 lifecycle, one stage per box):

    ProfileStage   instrumented run -> interval Profile
    SelectStage    selection methodology -> Selection
    MarkStage      marker planning + warmup -> [Nugget]
    BaselineStage  full-run ground truth per platform (validation input)
    ReplayStage    native nugget replay per platform -> [ReplayResult]
    ValidateStage  prediction/speedup error + consistency -> report dict

``run`` resolves the stage's content address from its resolved config
(``spec``) plus the keys of its upstream artifacts, loads the payload on a
hit, computes-and-commits on a miss, and records a manifest entry either
way.  Stages therefore resume: changing only the selector re-runs
selection and everything downstream of it while profile and baseline
artifacts hit the cache.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

from repro_torch import obs
from repro_torch.core.nugget import Nugget, create_nuggets
from repro_torch.core.replay import ReplayEngine, ReplayResult
from repro_torch.core.select import SELECTORS, Selection
from repro_torch.core.validate import full_run_baseline, validation_report
from repro_torch.pipeline.store import Artifact, ArtifactStore


class Stage:
    """One pipeline step.  Subclasses define ``kind``, ``spec``,
    ``deps``, ``compute`` and the payload codec (``save``/``load``).

    ``deps`` names the upstream *stages* this one consumes; it is both
    the edge list the concurrent DAG scheduler executes and the source
    of ``upstream`` (the consumed artifact *keys* that chain into this
    stage's content address) — one declaration, two uses, so the
    scheduler can never run a stage before the artifacts its key
    depends on exist.
    """

    kind: str = ""
    name: str = ""

    # -- to override ---------------------------------------------------
    def spec(self, ctx) -> Dict:
        raise NotImplementedError

    def deps(self, ctx) -> List[str]:
        """Names of the stages whose artifacts this stage consumes."""
        return []

    def compute(self, ctx) -> Any:
        raise NotImplementedError

    # -- derived -------------------------------------------------------
    def upstream(self, ctx) -> List[str]:
        return [ctx.key(name) for name in self.deps(ctx)]

    def save(self, store: ArtifactStore, art: Artifact, payload: Any) -> None:
        raise NotImplementedError

    def load(self, store: ArtifactStore, art: Artifact) -> Any:
        raise NotImplementedError

    # -- uniform run ---------------------------------------------------
    def run(self, ctx) -> Artifact:
        t0 = time.perf_counter()
        journal = getattr(ctx, "journal_event", None)
        with obs.span(f"stage.{self.name}", kind=self.kind) as sp:
            art = ctx.store.resolve(self.kind, self.spec(ctx),
                                    self.upstream(ctx))
            if journal is not None:
                journal("stage_start", stage=self.name,
                        artifact_kind=self.kind, key=art.key)
            # single-flight: concurrent stages (or pipelines) resolving
            # the same key serialize here — one computes, the rest load.
            # ``lookup`` = exists + payload verification: a corrupt
            # artifact is quarantined and recomputed as a plain miss.
            with ctx.store.single_flight(art.key):
                hit = ctx.store.lookup(art)
                if hit:
                    with obs.span(f"stage.{self.name}.load"):
                        payload = self.load(ctx.store, art)
                else:
                    with obs.span(f"stage.{self.name}.compute"):
                        payload = self.compute(ctx)
                    with obs.span(f"stage.{self.name}.save"):
                        self.save(ctx.store, art, payload)
                        ctx.store.commit(art)
            if journal is not None:
                journal("stage_commit", stage=self.name, key=art.key,
                        cache_hit=hit)
            sp.set(key=art.key, cache_hit=hit,
                   upstream=[k[:12] for k in art.upstream])
        wall = time.perf_counter() - t0
        obs.metrics().observe(f"pipeline.stage_s.{self.kind}", wall)
        obs.metrics().count(f"pipeline.{'hits' if hit else 'misses'}")
        ctx.record(self, art, payload, hit, wall)
        return art


class ProfileStage(Stage):
    """Instrumented run on the profile platform -> interval Profile."""

    kind = "profile"
    name = "profile"

    def spec(self, ctx) -> Dict:
        cfg = ctx.cfg
        return {**cfg.platform_spec(cfg.profile_platform_name),
                "steps": cfg.steps, "interval_steps": cfg.interval_steps}

    def compute(self, ctx):
        tr = ctx.trainer(ctx.cfg.profile_platform_name)
        tr.run(ctx.cfg.steps)
        # sharded finalize: with a worker pool the deferred step log is
        # split into chunks, analyzed concurrently and merged in stream
        # order — bit-for-bit identical to the serial profile
        return tr.profile(max_workers=ctx.workers or None)

    def save(self, store, art, payload):
        store.write_profile(art, payload)

    def load(self, store, art):
        return store.read_profile(art)


class SelectStage(Stage):
    kind = "selection"
    name = "select"

    def spec(self, ctx) -> Dict:
        return {"selector": ctx.cfg.selector,
                "args": dict(sorted(ctx.cfg.selector_args.items()))}

    def deps(self, ctx):
        return ["profile"]

    def compute(self, ctx):
        sel_cls = SELECTORS[ctx.cfg.selector]
        return sel_cls(**ctx.cfg.selector_args).select(ctx.payload("profile"))

    def save(self, store, art, payload):
        store.write_json(art, "selection.json", payload.to_json())

    def load(self, store, art):
        return Selection.from_json(store.read_json(art, "selection.json"))


class MarkStage(Stage):
    kind = "nuggets"
    name = "mark"

    def spec(self, ctx) -> Dict:
        cfg = ctx.cfg
        return {"warmup_intervals": cfg.warmup_intervals,
                "search_distance": cfg.search_distance,
                "ckpt_every": cfg.ckpt_every}

    def deps(self, ctx):
        return ["profile", "select"]

    def compute(self, ctx):
        cfg = ctx.cfg
        return create_nuggets(ctx.payload("profile"), ctx.payload("select"),
                              warmup_intervals=cfg.warmup_intervals,
                              search_distance=cfg.search_distance,
                              ckpt_every=cfg.ckpt_every)

    def save(self, store, art, payload):
        store.write_json(art, "nuggets.json",
                         {"nuggets": [n.to_json() for n in payload]})

    def load(self, store, art):
        d = store.read_json(art, "nuggets.json")
        return [Nugget.from_json(n) for n in d["nuggets"]]


class BaselineStage(Stage):
    """Full-run ground-truth wall time for one platform.  Depends only on
    the platform + run shape, never on the selection — so changing the
    selector reuses cached baselines."""

    kind = "baseline"

    def __init__(self, platform: str):
        self.platform = platform
        self.name = f"baseline@{platform}"

    def spec(self, ctx) -> Dict:
        return {**ctx.cfg.platform_spec(self.platform), "steps": ctx.cfg.steps}

    def compute(self, ctx):
        return full_run_baseline(ctx.runner(self.platform), ctx.cfg.steps)

    def save(self, store, art, payload):
        store.write_json(art, "baseline.json", payload)

    def load(self, store, art):
        return store.read_json(art, "baseline.json")


class ReplayStage(Stage):
    """Native nugget replay on one platform -> [ReplayResult]."""

    kind = "replay"

    def __init__(self, platform: str):
        self.platform = platform
        self.name = f"replay@{platform}"

    def spec(self, ctx) -> Dict:
        return ctx.cfg.platform_spec(self.platform)

    def deps(self, ctx):
        return ["profile", "mark"]

    def compute(self, ctx):
        eng = ReplayEngine(ctx.runner(self.platform), ctx.payload("profile"))
        return eng.replay_all(ctx.payload("mark"))

    def save(self, store, art, payload):
        store.write_json(art, "replay.json",
                         {"platform": self.platform,
                          "results": [r.to_json() for r in payload]})

    def load(self, store, art):
        d = store.read_json(art, "replay.json")
        return [ReplayResult.from_json(r) for r in d["results"]]


class ValidateStage(Stage):
    kind = "validation"
    name = "validate"

    def spec(self, ctx) -> Dict:
        return {"platforms": list(ctx.cfg.platforms)}

    def deps(self, ctx):
        names = ["profile", "mark"]
        for p in ctx.cfg.platforms:
            names.append(f"replay@{p}")
            names.append(f"baseline@{p}")
        return names

    def compute(self, ctx):
        results_by = {p: ctx.payload(f"replay@{p}") for p in ctx.cfg.platforms}
        baselines = {p: ctx.payload(f"baseline@{p}")
                     for p in ctx.cfg.platforms}
        return validation_report(ctx.payload("profile"), results_by, baselines)

    def save(self, store, art, payload):
        store.write_json(art, "validation.json", payload)

    def load(self, store, art):
        return store.read_json(art, "validation.json")
