"""The port's staged pipeline on the CPU at the reduced size, as
`tests/test_pipeline_stages.py` holds the JAX package's: a cold run computes
every stage, a warm run hits every stage and builds no trainer, a selector
change re-runs only selection and what follows it, an interval change
invalidates the profile, and `workers=4` reproduces the serial run's keys and
bytes.  Against the JAX package: the configs the pipeline trains, the profile
(interval bounds in step space and BBVs, byte for byte; unit-of-work values
are IR-specific and not compared) and the launcher's manifest schema."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.pipeline import PipelineConfig as JxPipelineConfig
from repro.pipeline import PipelineContext as JxPipelineContext
from repro.pipeline import ProfileStage as JxProfileStage
from repro_torch.configs.base import config_dict
from repro_torch.core.profile_store import load_profile
from repro_torch.pipeline import (ArtifactStore, Pipeline, PipelineConfig,
                                  PipelineContext, ProfileStage,
                                  platform_config)
from repro_torch.pipeline.runtime import EXEC_FIELDS
from test_torch_pipeline_host import payload_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "mamba2-780m", "olmoe-1b-7b")
PLATFORMS = ("f32", "bf16")
RUN = dict(platforms=PLATFORMS, selector="random",
           selector_args={"n_samples": 3, "seed": 0}, steps=8, seq_len=16,
           batch=2, interval_steps=2.0, seed=0, device="cpu")
STAGE_NAMES = ["profile", "select", "mark", "baseline@f32", "baseline@bf16",
               "replay@f32", "replay@bf16", "validate"]


def _cfg(arch, **kw):
    return PipelineConfig(arch=arch, **{**RUN, **kw})


class _Spy:
    """Counts the trainers a run builds (`PipelineContext.trainer` imports
    `repro_torch.train.Trainer` when it builds one)."""

    def __init__(self, monkeypatch):
        import repro_torch.train as train_pkg
        real, built = train_pkg.Trainer, []

        class Trainer(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self)

        monkeypatch.setattr(train_pkg, "Trainer", Trainer)
        self.built = built


def hits(manifest):
    return {s["stage"]: s["cache_hit"] for s in manifest["stages"]}


def keys(manifest):
    return {s["stage"]: s["key"] for s in manifest["stages"]}


@pytest.fixture(scope="module", params=ARCHS)
def cold(request, tmp_path_factory):
    store = str(tmp_path_factory.mktemp(f"store-{request.param}"))
    return request.param, store, Pipeline(_cfg(request.param), store).run()


def test_cold_run_computes_every_stage(cold):
    arch, _, m = cold
    assert [s["stage"] for s in m["stages"]] == STAGE_NAMES
    assert m["cache_hits"] == 0 and m["cache_misses"] == len(STAGE_NAMES)
    met = m["metrics"]
    for p in PLATFORMS:
        assert met["platforms"][p]["actual_s"] > 0
        assert met["platforms"][p]["predicted_s"] > 0
    assert len(met["nugget_variability"]) == 3
    assert len(met["speedup_errors"]) == 1
    assert m["config"]["device"] == "cpu" and m["config"]["arch"] == arch
    prof = load_profile(os.path.join(m["stages"][0]["path"], "profile"))
    assert prof.n_intervals == 4


def test_warm_run_hits_every_stage_and_builds_no_trainer(cold, monkeypatch):
    arch, store, m = cold
    spy = _Spy(monkeypatch)
    warm = Pipeline(_cfg(arch), store).run()
    assert all(hits(warm).values()), hits(warm)
    assert spy.built == []
    assert keys(warm) == keys(m)
    assert warm["metrics"] == m["metrics"]
    sw = warm["obs"]["store_counters"]
    assert sw["hit"] == len(STAGE_NAMES) and sw["miss"] == 0, sw
    assert sw["put_bytes"] == 0


def test_selector_change_reuses_profile_and_baseline(cold):
    arch, store, m = cold
    changed = Pipeline(_cfg(arch, selector="systematic",
                            selector_args={"n_samples": 3}), store).run()
    h = hits(changed)
    assert h == {name: name in ("profile", "baseline@f32", "baseline@bf16")
                 for name in STAGE_NAMES}, h
    assert keys(changed)["profile"] == keys(m)["profile"]
    assert keys(changed)["select"] != keys(m)["select"]


def test_interval_change_invalidates_the_profile(cold):
    arch, store, m = cold
    changed = Pipeline(_cfg(arch, interval_steps=4.0), store).run()
    h = hits(changed)
    assert not h["profile"], h
    assert h["baseline@f32"] and h["baseline@bf16"], h


def test_parallel_run_gives_the_serial_keys_and_bytes(cold, tmp_path):
    arch, _, m = cold
    par = Pipeline(_cfg(arch, workers=4), str(tmp_path)).run()
    assert par["workers"] == 4
    assert [s["stage"] for s in par["stages"]] == STAGE_NAMES
    assert par["cache_misses"] == len(STAGE_NAMES)
    assert keys(par) == keys(m)
    paths = {s["stage"]: s["path"] for s in par["stages"]}
    cold_paths = {s["stage"]: s["path"] for s in m["stages"]}
    for stage in ("profile", "select", "mark"):
        got, want = payload_bytes(paths[stage]), payload_bytes(cold_paths[stage])
        assert got and got == want, stage

    def strip_times(path):
        with open(os.path.join(path, "replay.json")) as f:
            doc = json.load(f)
        for r in doc["results"]:
            for k in [k for k in r if k.endswith("_s")]:
                del r[k]
        return doc

    for p in PLATFORMS:
        assert strip_times(paths[f"replay@{p}"]) == \
            strip_times(cold_paths[f"replay@{p}"])


def test_profile_matches_the_jax_pipeline(cold, tmp_path):
    """The profile stage of both packages on one config: the same interval
    bounds in step space and the same BBVs, byte for byte; the cold run's
    stored profile is the port's own.  An MoE profile's `expert_tok_*` and
    `dropped_tokens` columns count the routing of the run, which depends on
    the parameters, so for MoE the port's profile trainer starts from the
    JAX trainer's initial parameters (converted; the kept initial parameters
    of `Trainer.init_state`)."""
    arch = cold[0]
    jcfg = JxPipelineConfig(arch=arch, **{k: v for k, v in RUN.items()
                                         if k != "device"})
    jctx = JxPipelineContext(jcfg, None)
    jprof = JxProfileStage().compute(jctx)
    pctx = PipelineContext(_cfg(arch), ArtifactStore(str(tmp_path / "own")))
    own = ProfileStage().compute(pctx)
    pprof = own
    if arch == "olmoe-1b-7b":
        from repro_torch.convert import params_from_numpy
        plat = jcfg.profile_platform_name
        init = jctx.trainer(plat).init_state().params
        pctx = PipelineContext(_cfg(arch), ArtifactStore(str(tmp_path)))
        ptr = pctx.trainer(plat)
        ptr._init_params = params_from_numpy(
            jax.tree.map(np.asarray, init), ptr.cfg, device="cpu")
        pprof = ProfileStage().compute(pctx)
        virt = pprof.table.virtual_ids()
        assert len(virt) == 5 and pprof.bbv_matrix()[:, virt[:-1]].min() > 0
    assert pprof.table.names == jprof.table.names
    assert pprof.n_intervals == jprof.n_intervals == 4
    for a, b in zip(pprof.intervals, jprof.intervals):
        assert (a.start_step, a.end_step) == (b.start_step, b.end_step)
        assert a.bbv.tobytes() == b.bbv.tobytes()
        assert a.hits_at_stamp.tobytes() == b.hits_at_stamp.tobytes()
        assert repr(a.end_marker.block) == repr(b.end_marker.block)
        assert a.end_marker.hits == b.end_marker.hits
    stored = load_profile(os.path.join(cold[2]["stages"][0]["path"],
                                       "profile"))
    np.testing.assert_array_equal(stored.bbv_matrix(), own.bbv_matrix())
    assert [(i.start_step, i.end_step) for i in stored.intervals] == \
        [(i.start_step, i.end_step) for i in own.intervals]


CONFIG_CASES = [(a, r, p) for a in ARCHS for r in (True, False)
                for p in ("f32", "bf16", "f32-ref", "bf16-chunk16")]


@pytest.mark.parametrize("arch,reduce,platform", CONFIG_CASES)
def test_pipeline_trains_the_jax_pipelines_config(arch, reduce, platform):
    """With the port's base config set to the chunked impls, every
    platform's config equals the JAX pipeline's, field for field; the
    platform spec adds only the backend and the device."""
    jcfg = JxPipelineConfig(arch=arch, reduce=reduce, seq_len=32)
    pcfg = PipelineConfig(arch=arch, reduce=reduce, seq_len=32, device="cpu")
    assert config_dict(pcfg.arch_for(platform)) == \
        dataclasses.asdict(jcfg.arch_for(platform))
    jspec, pspec = jcfg.platform_spec(platform), pcfg.platform_spec(platform)
    assert {k: v for k, v in pspec.items()
            if k not in ("backend", "device")} == jspec
    assert (pspec["backend"], pspec["device"]) == ("torch", "cpu")


def test_platform_tokens_parse_as_the_jax_ones():
    from repro.pipeline import platform_config as jx_platform_config
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as pget
    for token in ("f32", "bf16", "f16", "f32-ref", "bf16-chunk16"):
        j = jx_platform_config(jget("qwen3-1.7b"), token)
        p = platform_config(dataclasses.replace(pget("qwen3-1.7b"),
                                                attention_impl="chunked",
                                                ssm_impl="chunked"), token)
        assert dataclasses.asdict(j) == config_dict(p)
    with pytest.raises(ValueError, match="unknown platform token"):
        platform_config(pget("qwen3-1.7b"), "tf32")


def test_stores_keep_backends_and_devices_apart():
    """A store shared with the JAX package, or between a CPU run and a card
    run, never serves one's artifact to the other: the keys differ."""
    from repro.pipeline import artifact_key as jx_key
    from repro_torch.pipeline import artifact_key
    jcfg = JxPipelineConfig(arch="qwen3-1.7b", seq_len=16)
    pcpu = PipelineConfig(arch="qwen3-1.7b", seq_len=16, device="cpu")
    pgpu = dataclasses.replace(pcpu, device="cuda")
    ks = {jx_key("baseline", jcfg.platform_spec("f32")),
          artifact_key("baseline", pcpu.platform_spec("f32")),
          artifact_key("baseline", pgpu.platform_spec("f32"))}
    assert len(ks) == 3
    # execution-only fields change no key, the device does
    assert "device" not in EXEC_FIELDS
    assert dataclasses.replace(pcpu, workers=4).run_key() == pcpu.run_key()
    assert pgpu.run_key() != pcpu.run_key()


def test_pipeline_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(PipelineConfig(arch="qwen3-1.7b"), str(tmp_path))


def test_traced_run_emits_one_span_per_stage(cold):
    from repro_torch import obs
    arch, store, _ = cold
    tracer = obs.configure(trace=True)
    try:
        m = Pipeline(_cfg(arch), store).run()
    finally:
        obs.configure(trace=False)
    assert m["obs"]["traced"]
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    names = [e["name"] for e in spans]
    for name in STAGE_NAMES:
        assert names.count(f"stage.{name}") == 1, name
    assert names.count("pipeline.run") == 1


def _launch(module, store, extra=(), env_extra=None):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    args = [sys.executable, "-m", module, "--arch", "qwen3-1.7b", "--reduced",
            "--steps", "6", "--seq-len", "16", "--batch", "2",
            "--interval-steps", "2", "--platforms", "f32",
            "--selector", "systematic", "--n-samples", "2",
            "--store", store, *extra]
    res = subprocess.run(args, capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def test_launcher_manifest_has_the_jax_launchers_schema(tmp_path):
    """`python -m repro_torch.launch.pipeline --device cpu` against
    `python -m repro.launch.pipeline` on the same flags: the same manifest
    keys, stage names and kinds, config fields (plus `device`) and
    validation keys; then `repro_torch.launch.obs` summarizes its trace."""
    trace = str(tmp_path / "trace")
    pm = _launch("repro_torch.launch.pipeline", str(tmp_path / "p"),
                 ("--device", "cpu", "--trace", trace))
    jm = _launch("repro.launch.pipeline", str(tmp_path / "j"))
    assert sorted(pm) == sorted(jm)
    assert [(s["stage"], s["kind"]) for s in pm["stages"]] == \
        [(s["stage"], s["kind"]) for s in jm["stages"]]
    assert sorted(pm["config"]) == sorted([*jm["config"], "device"])
    assert sorted(pm["metrics"]) == sorted(jm["metrics"])
    assert sorted(pm["fault_tolerance"]) == sorted(jm["fault_tolerance"])
    assert pm["cache_misses"] == len(pm["stages"])
    assert os.path.exists(os.path.join(trace, "trace.json"))
    from repro_torch.launch import obs as obs_cli
    assert obs_cli.main([trace, "--json"]) == 0


def test_verify_skills_olmoe_pipeline_command_on_the_cpu(tmp_path, capsys):
    """The verify skill's first command, an MoE pipeline, on the port with
    `--device cpu`: cold (every stage computes), warm (every stage hits),
    and a selector change (profile and baseline hit; select, mark, replay
    and validate re-run)."""
    from repro_torch.launch import pipeline as cli
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "16",
            "--seq-len", "16", "--batch", "2", "--n-samples", "4",
            "--platforms", "f32", "--store", str(tmp_path), "--device", "cpu"]
    cold = cli.main([*argv, "--selector", "random"])
    warm = cli.main([*argv, "--selector", "random"])
    changed = cli.main([*argv, "--selector", "kmeans"])
    capsys.readouterr()
    names = ["profile", "select", "mark", "baseline@f32", "replay@f32",
             "validate"]
    assert [s["stage"] for s in cold["stages"]] == names
    assert cold["cache_misses"] == len(names)
    assert warm["cache_misses"] == 0 and all(hits(warm).values())
    assert keys(warm) == keys(cold)
    assert hits(changed) == {n: n in ("profile", "baseline@f32")
                             for n in names}
    prof = load_profile(os.path.join(cold["stages"][0]["path"], "profile"))
    virt = prof.table.virtual_ids()
    assert prof.table.names[virt[0]] == "expert_tok_0"
    assert prof.bbv_matrix()[:, virt[:-1]].sum() > 0
