"""The pipeline's host code in the port against the JAX package: the same
inputs, made with numpy from a seed, give byte-equal outputs (k-means,
selections, markers, nuggets, profile files, artifact keys, the scheduler's
order and retry statistics, fault decisions, validation reports, and what
the replay engine runs and records)."""
import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest

from repro.core import kmeans as jx_kmeans
from repro.core import markers as jx_markers
from repro.core import nugget as jx_nugget
from repro.core import profile_store as jx_store
from repro.core import replay as jx_replay
from repro.core import select as jx_select
from repro.core import validate as jx_validate
from repro.core.intervals import build_profile as jx_build_profile
from repro.core.intervals_vec import as_steps as jx_as_steps
from repro.core.registry import BlockDef as JxBlockDef
from repro.core.registry import BlockTable as JxBlockTable
from repro.core.registry import Segment as JxSegment
from repro import faults as jx_faults
from repro.pipeline import journal as jx_journal
from repro.pipeline import scheduler as jx_scheduler
from repro.pipeline import store as jx_pstore
from repro_torch.core import kmeans as pt_kmeans
from repro_torch.core import markers as pt_markers
from repro_torch.core import nugget as pt_nugget
from repro_torch.core import profile_store as pt_store
from repro_torch.core import replay as pt_replay
from repro_torch.core import select as pt_select
from repro_torch.core import validate as pt_validate
from repro_torch.core.intervals_vec import as_steps as pt_as_steps
from repro_torch import faults as pt_faults
from repro_torch.pipeline import journal as pt_journal
from repro_torch.pipeline import scheduler as pt_scheduler
from repro_torch.pipeline import store as pt_pstore

SEED = 0
N_STEPS = 48


def _stream(seed=SEED, n_steps=N_STEPS):
    """A phased step stream: three phases of different dynamic work (the
    `aux` block's hits), with noise from a numpy seed."""
    rng = np.random.default_rng(seed)
    phase = (np.arange(n_steps) * 3 // n_steps)
    base = np.array([1.0, 6.0, 3.0])[phase]
    aux = np.round(base + rng.uniform(0, 1.5, n_steps), 3)
    return [{"aux": float(a)} for a in aux]


def _jax_profile(seed=SEED):
    table = JxBlockTable([JxBlockDef("embed", 4.0), JxBlockDef("layer", 10.0),
                          JxBlockDef("head", 3.0),
                          JxBlockDef("aux", 2.0, virtual=True, dyn_key="aux")],
                         [JxSegment((0,), 1), JxSegment((1,), 4),
                          JxSegment((2,), 1)])
    steps = jx_as_steps(n_steps=N_STEPS, dyn_per_step=_stream(seed))
    return jx_build_profile(table, table.step_uow() * 2.5, steps)


def payload_bytes(path) -> dict:
    """{relative name: bytes} of every file under ``path`` but ``spec.json``
    (an artifact's provenance); an ``.npz`` by its members' bytes, since its
    zip headers hold the time it was written."""
    out = {}
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            if f == "spec.json":
                continue
            full = os.path.join(d, f)
            rel = os.path.relpath(full, path)
            if f.endswith(".npz"):
                with zipfile.ZipFile(full) as z:
                    out.update({f"{rel}/{n}": z.read(n) for n in z.namelist()})
            else:
                with open(full, "rb") as fh:
                    out[rel] = fh.read()
    return out


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One profile written by the JAX `save_profile`, loaded by both."""
    d = str(tmp_path_factory.mktemp("shared-profile"))
    jx_store.save_profile(d, _jax_profile())
    return jx_store.load_profile(d), pt_store.load_profile(d)


# ---------------------------------------------------------------------------
# k-means, selectors, markers, nuggets
# ---------------------------------------------------------------------------


def test_kmeans_functions_agree():
    x = np.random.default_rng(3).normal(size=(40, 6))
    jc, ja = jx_kmeans.kmeans(x, 4, seed=1)[:2]
    pc, pa = pt_kmeans.kmeans(x, 4, seed=1)[:2]
    np.testing.assert_array_equal(jc, pc)
    np.testing.assert_array_equal(ja, pa)
    np.testing.assert_array_equal(jx_kmeans.random_projection(x, 3, seed=2),
                                  pt_kmeans.random_projection(x, 3, seed=2))
    jk = jx_kmeans.pick_k_silhouette(x, max_k=6, seed=0)
    pk = pt_kmeans.pick_k_silhouette(x, max_k=6, seed=0)
    assert jk[0] == pk[0]
    np.testing.assert_array_equal(jk[1], pk[1])


SELECTORS = [("random", {"n_samples": 5, "seed": 3}),
             ("systematic", {"n_samples": 5}),
             ("kmeans", {"seed": 0, "max_k": 6})]


@pytest.mark.parametrize("name,args", SELECTORS, ids=[s for s, _ in SELECTORS])
def test_selection_and_nuggets_are_byte_equal(shared, name, args):
    jprof, pprof = shared
    jsel = jx_select.SELECTORS[name](**args).select(jprof)
    psel = pt_select.SELECTORS[name](**args).select(pprof)
    assert json.dumps(jsel.to_json()) == json.dumps(psel.to_json())
    kw = dict(warmup_intervals=1, search_distance=0.3 * jprof.step_uow,
              ckpt_every=4)
    jn = jx_nugget.create_nuggets(jprof, jsel, **kw)
    pn = pt_nugget.create_nuggets(pprof, psel, **kw)
    assert len(jn) == len(pn) > 0
    assert json.dumps([n.to_json() for n in jn]) == \
        json.dumps([n.to_json() for n in pn])


def test_selectors_are_the_same_set():
    assert sorted(jx_select.SELECTORS) == sorted(pt_select.SELECTORS)


@pytest.mark.parametrize("warmup,search", [(0, 0.0), (1, 0.0), (2, 0.5)])
def test_marker_plans_are_equal(shared, warmup, search):
    jprof, pprof = shared
    for idx in range(jprof.n_intervals):
        jp = jx_markers.plan_markers(jprof, idx, warmup_intervals=warmup,
                                     search_distance=search * jprof.step_uow)
        pp = pt_markers.plan_markers(pprof, idx, warmup_intervals=warmup,
                                     search_distance=search * pprof.step_uow)
        assert repr(dataclasses.asdict(jp)) == repr(dataclasses.asdict(pp))


def test_save_nuggets_files_are_byte_equal(shared, tmp_path):
    jprof, pprof = shared
    jsel = jx_select.KMeansSelector(seed=0, max_k=6).select(jprof)
    psel = pt_select.KMeansSelector(seed=0, max_k=6).select(pprof)
    jx_nugget.save_nuggets(str(tmp_path / "j.json"),
                           jx_nugget.create_nuggets(jprof, jsel), jsel)
    pt_nugget.save_nuggets(str(tmp_path / "p.json"),
                           pt_nugget.create_nuggets(pprof, psel), psel)
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "p.json").read_bytes()
    nugs, sel = pt_nugget.load_nuggets(str(tmp_path / "j.json"))
    assert sel.interval_ids == jsel.interval_ids and len(nugs) == len(jsel.interval_ids)


# ---------------------------------------------------------------------------
# profile store
# ---------------------------------------------------------------------------


def test_save_profile_directories_are_byte_equal(shared, tmp_path):
    jprof, pprof = shared
    jx_store.save_profile(str(tmp_path / "j"), jprof)
    pt_store.save_profile(str(tmp_path / "p"), pprof)
    jf, pf = payload_bytes(tmp_path / "j"), payload_bytes(tmp_path / "p")
    assert sorted(jf) == sorted(pf)
    for name in jf:
        assert jf[name] == pf[name], name


def test_each_package_loads_the_others_profile(shared, tmp_path):
    jprof, pprof = shared
    pt_store.save_profile(str(tmp_path / "p"), pprof)
    back = jx_store.load_profile(str(tmp_path / "p"))
    np.testing.assert_array_equal(back.bbv_matrix(), jprof.bbv_matrix())
    assert [(iv.start_uow, iv.end_uow, iv.start_step, iv.end_step)
            for iv in back.intervals] == \
        [(iv.start_uow, iv.end_uow, iv.start_step, iv.end_step)
         for iv in pprof.intervals]
    assert back.table.to_json() == pprof.table.to_json()
    for a, b in zip(back.intervals, pprof.intervals):
        assert repr(a.end_marker) == repr(b.end_marker)
        np.testing.assert_array_equal(a.stamps, b.stamps)
        np.testing.assert_array_equal(a.hits_at_stamp, b.hits_at_stamp)
    for k in jprof.dyn_history:
        np.testing.assert_array_equal(back.dyn_history[k], pprof.dyn_history[k])


def test_stream_digest_and_cache_key_are_equal(shared):
    jprof, pprof = shared
    dyn = _stream(seed=5)
    js = jx_as_steps(n_steps=len(dyn), dyn_per_step=dyn)
    ps = pt_as_steps(n_steps=len(dyn), dyn_per_step=dyn)
    assert jx_store.stream_digest(js) == pt_store.stream_digest(ps)
    assert jx_store.profile_cache_key(jprof.table, 7.5, js) == \
        pt_store.profile_cache_key(pprof.table, 7.5, ps)


def test_cached_build_is_shared_across_packages(shared, tmp_path):
    """A cache entry written by one package is a hit for the other."""
    jprof, pprof = shared
    dyn = _stream(seed=6)
    ps = pt_as_steps(n_steps=len(dyn), dyn_per_step=dyn)
    js = jx_as_steps(n_steps=len(dyn), dyn_per_step=dyn)
    p1, hit1 = pt_store.cached_build(str(tmp_path), pprof.table, 9.0, ps)
    j1, hit2 = jx_store.cached_build(str(tmp_path), jprof.table, 9.0, js)
    assert (hit1, hit2) == (False, True)
    np.testing.assert_array_equal(p1.bbv_matrix(), j1.bbv_matrix())


# ---------------------------------------------------------------------------
# artifact store, scheduler, faults, journal
# ---------------------------------------------------------------------------


SPECS = [
    {"arch": {"name": "qwen3-1.7b", "d_model": 2048}, "platform": "bf16",
     "seq_len": 256, "steps": 16, "interval_steps": 2.0},
    {"selector": "kmeans", "args": {"seed": 0}},
    {"b": (1, 2, 3), "a": np.arange(3), "nested": {"z": 1.5, "y": None}},
]


@pytest.mark.parametrize("spec", SPECS, ids=["platform", "selector", "mixed"])
def test_artifact_key_and_canonical_json_are_equal(spec):
    assert jx_pstore.canonical_json(spec) == pt_pstore.canonical_json(spec)
    for kind, up in (("profile", ()), ("replay", ("ab" * 32, "cd" * 32))):
        assert jx_pstore.artifact_key(kind, spec, up) == \
            pt_pstore.artifact_key(kind, spec, up)


def test_artifact_kinds_are_equal():
    assert jx_pstore.ARTIFACT_KINDS == pt_pstore.ARTIFACT_KINDS


def _dag_run(pkg_sched, pkg_faults, workers, spec):
    order = ["profile", "select", "mark", "baseline@a", "baseline@b",
             "replay@a", "replay@b", "validate"]
    deps = {"select": ["profile"], "mark": ["profile", "select"],
            "replay@a": ["profile", "mark"], "replay@b": ["profile", "mark"],
            "validate": ["mark", "replay@a", "replay@b", "baseline@a",
                         "baseline@b"]}
    inj = pkg_faults.FaultInjector.from_spec(spec, seed=7)
    ran = []

    def node(name):
        inj.fire("stage", name)
        ran.append(name)

    stats = pkg_sched.run_dag(order, deps, node, max_workers=workers,
                              retry=pkg_faults.RetryPolicy(max_attempts=6,
                                                           backoff_s=0.0))
    return ran, stats, inj.summary()


def test_run_dag_order_and_retry_stats_are_equal():
    spec = "raise:stage=*,p=0.4;raise:stage=replay*,n=1"
    jran, jstats, jsum = _dag_run(jx_scheduler, jx_faults, 0, spec)
    pran, pstats, psum = _dag_run(pt_scheduler, pt_faults, 0, spec)
    assert jran == pran
    assert jstats == pstats
    assert jstats["retries"] > 0
    strip = lambda s: {**s, "events": [{k: v for k, v in e.items() if k != "t"}
                                       for e in s["events"]]}
    assert strip(jsum) == strip(psum)


def test_run_dag_with_workers_runs_every_node_once_after_its_deps():
    # a budget (n=) and not a probability: with threads the order of the
    # injector's calls, and so its draws, depends on the schedule
    spec = "raise:stage=replay*,n=1"
    pran, pstats, _ = _dag_run(pt_scheduler, pt_faults, 4, spec)
    jran, jstats, _ = _dag_run(jx_scheduler, jx_faults, 4, spec)
    assert sorted(pran) == sorted(jran)
    assert pstats == jstats and pstats["retries"] == 1
    assert pran.index("validate") == len(pran) - 1
    assert pran.index("profile") < pran.index("select") < pran.index("mark")


FAULT_SPECS = ["raise:stage=*,p=0.3", "fatal:stage=mark,n=1;raise:p=0.5,n=3",
               "kill:stage=replay*,p=0.5", "stall:stage=profile,s=0,n=2"]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_injector_decisions_are_equal(spec):
    sites = ["profile", "select", "mark", "replay@f32", "replay@bf16",
             "validate"] * 4

    def decisions(pkg):
        inj = pkg.FaultInjector.from_spec(spec, seed=11)
        out = []
        for s in sites:
            try:
                inj.fire("stage", s)
                out.append(None)
            except Exception as e:       # the injected failures only
                out.append((type(e).__name__, pkg.classify(e)))
        return out

    assert decisions(jx_faults) == decisions(pt_faults)


def test_fault_corrupt_flips_the_same_byte(tmp_path):
    for pkg, d in ((jx_faults, tmp_path / "j"), (pt_faults, tmp_path / "p")):
        d.mkdir()
        (d / "a.json").write_bytes(b'{"x": 1}')
        inj = pkg.FaultInjector.from_spec("corrupt:stage=*,n=1", seed=0)
        assert inj.corrupt(str(d), "select") is True
        assert inj.corrupt(str(d), "select") is False
    assert (tmp_path / "j" / "a.json").read_bytes() == \
        (tmp_path / "p" / "a.json").read_bytes()


def test_retry_policy_delays_are_equal():
    jp = jx_faults.RetryPolicy(max_attempts=5, backoff_s=0.1)
    pp = pt_faults.RetryPolicy(max_attempts=5, backoff_s=0.1)
    for key in ("profile", "replay@bf16"):
        assert [jp.delay(key, a) for a in range(1, 5)] == \
            [pp.delay(key, a) for a in range(1, 5)]


def test_journal_records_and_reads_back_alike(tmp_path):
    events = [("run_start", {"pid": 1}), ("stage_start", {"stage": "profile"}),
              ("stage_commit", {"stage": "profile", "key": "k1"}),
              ("stage_commit", {"stage": "select", "key": "k2"})]
    out = {}
    for name, pkg in (("j", jx_journal), ("p", pt_journal)):
        path = str(tmp_path / name / "run.jsonl")
        with pkg.RunJournal(path) as j:
            for kind, fields in events:
                j.append(kind, **fields)
        with open(path, "a") as f:
            f.write('{"torn": ')                 # a crash mid-line
        read = pkg.RunJournal.read(path)
        out[name] = ([{k: v for k, v in e.items() if k != "t"} for e in read],
                     pkg.RunJournal.committed(read))
    assert out["j"] == out["p"]
    assert out["p"][1] == {"profile": "k1", "select": "k2"}


# ---------------------------------------------------------------------------
# validation and replay
# ---------------------------------------------------------------------------


def _results(pkg, rng, n):
    return [pkg.ReplayResult(i, int(rng.integers(0, 10)),
                             float(rng.uniform(0.1, 0.5)),
                             float(rng.uniform(0.01, 0.2)), 2, 1,
                             float(rng.uniform(10, 20))) for i in range(n)]


def test_validation_report_is_equal(shared):
    jprof, pprof = shared
    baselines = {"bf16": {"n_steps": 16, "actual_s": 1.25},
                 "f32": {"n_steps": 16, "actual_s": 2.5},
                 "bf16-ref": {"n_steps": 16, "actual_s": 1.75}}
    jres, pres = {}, {}
    for i, p in enumerate(baselines):
        jres[p] = _results(jx_replay, np.random.default_rng(i), 4)
        pres[p] = _results(pt_replay, np.random.default_rng(i), 4)
    jrep = jx_validate.validation_report(jprof, jres, baselines)
    prep = pt_validate.validation_report(pprof, pres, baselines)
    assert json.dumps(jrep, sort_keys=True) == json.dumps(prep, sort_keys=True)
    assert len(prep["speedup_errors"]) == 3
    assert pt_validate.signature_divergence(pprof, pprof) == \
        jx_validate.signature_divergence(jprof, jprof)


def test_replay_result_json_is_equal():
    rng = np.random.default_rng(2)
    (jr,), (pr,) = _results(jx_replay, rng, 1), \
        _results(pt_replay, np.random.default_rng(2), 1)
    assert json.dumps(jr.to_json()) == json.dumps(pr.to_json())
    assert pt_replay.ReplayResult.from_json(jr.to_json()) == pr


class _CountingRunner:
    """A StepRunner that records what it is asked to do; no device work."""

    def __init__(self):
        self.calls = []

    def reset(self, step):
        self.calls.append(("reset", step))
        return {"step": step}

    def run_step(self, state, step):
        self.calls.append(("step", step))
        return {"step": step + 1}

    def sync(self, state):
        self.calls.append(("sync", state["step"]))


@pytest.mark.parametrize("ckpt_every,warmup", [(0, 1), (4, 1), (0, 2)])
def test_replay_engine_runs_what_the_jax_engine_runs(shared, ckpt_every,
                                                     warmup):
    jprof, pprof = shared
    jsel = jx_select.SystematicSelector(n_samples=4).select(jprof)
    psel = pt_select.SystematicSelector(n_samples=4).select(pprof)
    kw = dict(warmup_intervals=warmup, ckpt_every=ckpt_every)
    jn = jx_nugget.create_nuggets(jprof, jsel, **kw)
    pn = pt_nugget.create_nuggets(pprof, psel, **kw)
    jrun, prun = _CountingRunner(), _CountingRunner()
    jout = jx_replay.ReplayEngine(jrun, jprof).replay_all(jn)
    pout = pt_replay.ReplayEngine(prun, pprof).replay_all(pn)
    assert jrun.calls == prun.calls
    strip = lambda r: {k: v for k, v in r.to_json().items()
                       if k != "region_time_s"}
    assert [strip(r) for r in jout] == [strip(r) for r in pout]
    assert all(r.region_time_s >= 0 for r in pout)


def test_measure_full_run_runs_what_the_jax_one_runs():
    jrun, prun = _CountingRunner(), _CountingRunner()
    jx_replay.measure_full_run(jrun, 6, start=1)
    pt_replay.measure_full_run(prun, 6, start=1)
    assert jrun.calls == prun.calls
    b = pt_validate.full_run_baseline(_CountingRunner(), 5)
    assert b["n_steps"] == 5 and b["actual_s"] >= 0
