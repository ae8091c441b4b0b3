"""The port's distributed modules against the JAX package, in one process:
sharding plans and specs on shape-only meshes (the production shapes and a
host shape), the heartbeat coordinator, int8 gradient compression, the
GPipe bubble, the optimizer state's axes, `build_model` under a plan, and
the fault-injected training run.  The multi-rank checks are in
`test_torch_distributed_ranks.py`."""
import dataclasses
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.configs import get_config as jx_get_config
from repro.configs import list_archs
from repro.distributed import faults as jx_faults
from repro.distributed import sharding as jx_sharding
from repro.distributed.pipeline import bubble_fraction as jx_bubble
from repro.models.model_zoo import build_model as jx_build_model
from repro.optim import adamw as jx_adamw
from repro.optim import grad_compress as jx_gc
from repro_torch.configs import ShapeConfig, reduced
from repro_torch.configs import get_config as pt_get_config
from repro_torch.core.blocks_lm import build_block_table
from repro_torch.distributed import faults as pt_faults
from repro_torch.distributed import sharding as pt_sharding
from repro_torch.distributed.pipeline import bubble_fraction as pt_bubble
from repro_torch.launch.mesh import (MeshShape, init_process_group,
                                     make_host_mesh, make_production_mesh)
from repro_torch.models.attention import HeadLayout
from repro_torch.models.model_zoo import build_model as pt_build_model
from repro_torch.optim import adamw as pt_adamw
from repro_torch.optim import grad_compress as pt_gc

MESHES = {"prod": make_production_mesh(),
          "multi_pod": make_production_mesh(multi_pod=True),
          "host_4x2": MeshShape(("data", "model"), (4, 2))}


def _flat(tree, prefix=""):
    """{key path: leaf} of a nested dict whose leaves are axes tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _plan_fields(plan):
    return (plan.rules, plan.tp_size, plan.dp_axes, plan.tp_axis)


# ---------------------------------------------------------------------------
# plans and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve", "serve_fsdp"])
@pytest.mark.parametrize("shard_seq", [False, True])
def test_logical_rules_equal_the_jax_package(mesh, mode, shard_seq):
    m = MESHES[mesh]
    got = pt_sharding.logical_rules(m, mode=mode, shard_seq=shard_seq)
    want = jx_sharding.logical_rules(m, mode=mode, shard_seq=shard_seq)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.mesh is None              # a shape-only mesh has no devices


@pytest.mark.parametrize("arch", list_archs())
def test_plans_and_param_specs_equal_the_jax_package(arch):
    """plan_for over both production meshes and the host shape, train and
    serve, with and without long_500k; then the spec of every parameter
    leaf at that plan's tp, by key path."""
    jcfg = jx_get_config(arch)
    pcfg = pt_get_config(arch)
    n = jcfg.param_count()
    assert pcfg.param_count() == n
    for m in MESHES.values():
        for mode in ("train", "serve"):
            for shape in ("", "long_500k"):
                got = pt_sharding.plan_for(m, arch, mode, shape, n)
                want = jx_sharding.plan_for(m, arch, mode, shape, n)
                assert _plan_fields(got) == _plan_fields(want), (mode, shape)
                jaxes = _flat(jx_build_model(jcfg, want).axes())
                paxes = _flat(pt_build_model(pcfg, got, device="cpu").axes())
                assert paxes.keys() == jaxes.keys()
                for key, axes in jaxes.items():
                    assert paxes[key] == axes, key
                    assert got.spec(axes) == tuple(want.spec(axes)), key


def test_serve_fsdp_threshold_is_the_references():
    """mistral-large-123b served on the production mesh crosses 8e9 bytes
    a tensor shard and gets FSDP; qwen3-1.7b does not."""
    m = make_production_mesh()
    big = pt_get_config("mistral-large-123b").param_count()
    small = pt_get_config("qwen3-1.7b").param_count()
    assert pt_sharding.plan_for(m, "mistral-large-123b", "serve", "",
                                big).lookup("embed") == "data"
    assert pt_sharding.plan_for(m, "qwen3-1.7b", "serve", "",
                                small).lookup("embed") is None


def test_spec_uses_a_mesh_axis_at_most_once():
    plan = pt_sharding.logical_rules(make_production_mesh(), mode="train")
    want = jx_sharding.logical_rules(make_production_mesh(), mode="train")
    for axes in (("heads", "mlp"), ("embed", "embed"), ("batch", "embed"),
                 ("vocab", "embed"), (None, "heads", None)):
        assert plan.spec(axes) == tuple(want.spec(axes)), axes
    assert plan.spec(("heads", "mlp")) == ("model", None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = make_production_mesh(multi_pod=True)
    assert pt_sharding.placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert pt_sharding.placements(m, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        pt_sharding.placements(m, (("data", "pod"),))


def test_uneven_sharding_raises_by_leaf_name():
    m = MESHES["host_4x2"]
    pl = pt_sharding.placements(m, ("data", "model"))
    pt_sharding.check_even("layers/mlp/wi/kernel", (8, 6), m, pl)
    with pytest.raises(ValueError, match="layers/mlp/wi/kernel: dim 1"):
        pt_sharding.check_even("layers/mlp/wi/kernel", (8, 5), m, pl)
    pl = pt_sharding.placements(MESHES["multi_pod"], (("pod", "data"),))
    with pytest.raises(ValueError, match="embed: dim 0 .* 32 shards"):
        pt_sharding.check_even("embed", (48,), MESHES["multi_pod"], pl)


def test_shard_is_the_identity_without_a_plan_or_a_dtensor():
    x = torch.ones(2, 3)
    assert pt_sharding.shard(x, "batch", "act_embed") is x
    with pt_sharding.use_rules(pt_sharding.logical_rules(MESHES["prod"])):
        assert pt_sharding.active_rules() is not None
        assert pt_sharding.shard(x, "batch", "act_embed") is x
        assert pt_sharding.spec_for(("batch", "mlp")) == ("data", "model")
    assert pt_sharding.active_rules() is None
    assert pt_sharding.spec_for(("batch",)) == ()


def test_production_mesh_is_shape_only():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {"data": 16,
                                                             "model": 16}
    mp = make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model")
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        assert init_process_group(os.path.join(d, "store"), 0, 1,
                                  device="cpu", timeout_s=60) == "gloo"
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh(device="cpu")


def test_placements_on_a_one_rank_gloo_mesh(one_rank_group):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_host_mesh(model=1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    plan = pt_sharding.logical_rules(mesh, mode="train")
    assert plan.mesh is mesh and plan.tp_size == 1
    pl = pt_sharding.placements(mesh, plan.spec(("embed", "mlp")))
    assert pl == (Shard(0), Shard(1))
    w = torch.arange(12.0).reshape(3, 4)
    tree = pt_sharding.distribute({"w": w.requires_grad_(True)},
                                  {"w": (mesh, pl)})
    assert isinstance(tree["w"], DTensor) and tree["w"].requires_grad
    assert tree["w"].placements == pl
    assert torch.equal(pt_sharding.to_plain(tree["w"]), w.detach())
    with pt_sharding.use_rules(plan):
        y = pt_sharding.shard(tree["w"], None, "act_embed")
        assert y is tree["w"]             # spec all None: no constraint
        y = pt_sharding.shard(tree["w"], "heads", None)
        assert y.placements == (Replicate(), Shard(0))
    shardings = pt_sharding.params_shardings(
        mesh, plan, {"a": ("embed", "mlp"), "b": {"c": ("vocab", None)}})
    assert shardings == {"a": (mesh, (Shard(0), Shard(1))),
                         "b": {"c": (mesh, (Replicate(), Shard(0)))}}


# ---------------------------------------------------------------------------
# heartbeat coordinator (tests/test_fault_tolerance.py's fast tests)
# ---------------------------------------------------------------------------


def _both(n, **kw):
    return (jx_faults.HeartbeatCoordinator(n, **kw),
            pt_faults.HeartbeatCoordinator(n, **kw))


def test_heartbeat_detects_dead_worker():
    pair = _both(3, timeout_s=0.05)
    for co in pair:
        co.heartbeat(0, 1)
        co.heartbeat(1, 1)
        co.heartbeat(2, 1)
    time.sleep(0.08)
    dead = []
    for co in pair:
        co.heartbeat(0, 2)
        co.heartbeat(1, 2)
        dead.append(co.check())
    assert dead == [[2], [2]]
    assert [co.alive_count() for co in pair] == [2, 2]
    assert pair[1].events == pair[0].events
    assert any(e["kind"] == "dead" for e in pair[1].events)
    assert pair[1].min_committed_step() == pair[0].min_committed_step() == 2


def test_straggler_strikes_recorded():
    pair = _both(2, timeout_s=10, straggler_factor=2.0)
    for co in pair:
        for s in range(20):
            co.heartbeat(0, s, step_time_s=0.1)
        co.heartbeat(1, 20, step_time_s=1.0)      # 10x median
    assert pair[1].events == pair[0].events
    assert any(e["kind"] == "straggler" for e in pair[1].events)
    assert pair[1].workers[1].slow_strikes == 1


def test_step_time_window_is_per_instance():
    co1 = pt_faults.HeartbeatCoordinator(1, timeout_s=10, straggler_factor=2.0)
    for s in range(20):
        co1.heartbeat(0, s, step_time_s=0.1)
    co2 = pt_faults.HeartbeatCoordinator(1, timeout_s=10, straggler_factor=2.0)
    co2.heartbeat(0, 0, step_time_s=1.0)      # its own first sample
    assert co2._times == [1.0]
    assert not co2.events, "fresh coordinator must not inherit medians"
    assert co2.workers[0].slow_strikes == 0


def test_fault_injecting_run_restarts_as_the_jax_package():
    """The restart state machine alone: the same kills, the same restarts,
    the same calls into the step function."""
    def run(mod):
        calls = []

        def run_steps(frm, to):
            calls.append((frm, to))
            return to
        r = mod.FaultInjectingRun(4, run_steps, ckpt_every=5,
                                  kill_at={1: 7, 2: 13})
        return r.run(16), r.restarts, calls
    assert run(pt_faults) == run(jx_faults)


def test_fault_injected_training_matches_uninterrupted(tmp_path):
    """Kill the 'fleet' at steps 7 and 13; restart from checkpoints; the
    final params must equal an uninterrupted run bit for bit
    (tests/test_fault_tolerance.py's slow test, on the port at the reduced
    size on the CPU)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import Trainer
    cfg = dataclasses.replace(reduced(pt_get_config("qwen3-1.7b")),
                              attention_impl="chunked", ssm_impl="chunked")

    def trainer(**kw):
        return Trainer(cfg, seq_len=16, batch=2, instrument=False,
                       device="cpu", **kw)

    s_ref = trainer().run(16)
    ck = str(tmp_path / "ck")
    state_box = {}

    def run_steps(frm: int, to: int) -> int:
        # restart path: restore from the latest checkpoint like a fresh
        # process
        st = trainer(ckpt_dir=ck, ckpt_every=5).run(to)
        state_box["state"] = st
        return int(st.step)

    run = pt_faults.FaultInjectingRun(4, run_steps, ckpt_every=5,
                                      kill_at={1: 7, 2: 13})
    assert run.run(16) == 16
    assert run.restarts == 2
    got = state_box["state"]
    for a, b in zip(tree_leaves(s_ref.params), tree_leaves(got.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# gradient compression (tests/test_optim.py's properties, both packages)
# ---------------------------------------------------------------------------


def _bits(x):
    return np.asarray(x).view(np.uint8) if np.asarray(x).dtype != np.int8 \
        else np.asarray(x)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-4, 1e3))
def test_quantize_int8_bit_equal_to_the_jax_package(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64,)) * scale).astype(np.float32)
    jq, js = jx_gc.quantize_int8(jnp.asarray(x))
    pq, ps = pt_gc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert np.float32(ps.item()).tobytes() == np.float32(js).tobytes()
    jd = np.asarray(jx_gc.dequantize(jq, js))
    pd = pt_gc.dequantize(pq, ps).numpy()
    np.testing.assert_array_equal(_bits(pd), _bits(jd))
    err = np.abs(pd - x)
    assert err.max() <= float(ps) / 2 + 1e-6     # half-ulp of the int8 grid


def test_compress_leaf_and_error_feedback_bit_equal_over_60_steps():
    """EF compression: the same payload, scale and residual as the JAX
    package at every step; the accumulated applied signal tracks the true
    accumulated gradient."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(128,)).astype(np.float32)
    jef, pef = jnp.zeros(128, jnp.float32), torch.zeros(128)
    applied = torch.zeros(128)
    for _ in range(60):
        jq, js, jef = jx_gc.compress_leaf(jnp.asarray(g), jef)
        pq, ps, pef = pt_gc.compress_leaf(torch.from_numpy(g), pef)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        assert np.float32(ps.item()) == np.float32(js)
        np.testing.assert_array_equal(_bits(pef.numpy()), _bits(jef))
        applied += pt_gc.dequantize(pq, ps)
    np.testing.assert_allclose(applied.numpy() / 60, g, atol=2e-2)


def test_compression_ratio_and_error_feedback_init_equal():
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}
    pt_tree = {"a": torch.zeros(3, 5), "b": {"c": torch.zeros(7),
                                            "d": torch.zeros(2, 2, 2)}}
    jx_tree = jax.tree.map(lambda s: jnp.zeros(s), shapes,
                           is_leaf=lambda x: isinstance(x, tuple))
    assert pt_gc.compression_ratio(pt_tree) == jx_gc.compression_ratio(jx_tree)
    ef = pt_gc.init_error_feedback(pt_tree)
    assert ef["b"]["d"].shape == (2, 2, 2) and ef["a"].dtype == torch.float32


# ---------------------------------------------------------------------------
# bubble, optimizer axes, build_model under a plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,m", [(4, 6), (1, 8), (8, 32), (2, 1)])
def test_bubble_fraction_equal(s, m):
    assert pt_bubble(s, m) == jx_bubble(s, m)


def test_opt_state_axes_equal_by_key_path():
    cfg = pt_get_config("qwen3-1.7b")
    axes = pt_build_model(cfg, device="cpu").axes()
    jaxes = jx_build_model(jx_get_config("qwen3-1.7b")).axes()
    got = pt_adamw.opt_state_axes(axes, pt_adamw.AdamWConfig())
    want = jx_adamw.opt_state_axes(jaxes, jx_adamw.AdamWConfig())
    assert got.step == want.step == ()
    for field in ("mu", "nu", "master"):
        assert _flat(getattr(got, field)) == _flat(getattr(want, field))
    # without a master copy each master leaf is an empty vector (None,)
    got = pt_adamw.opt_state_axes(axes, pt_adamw.AdamWConfig(use_master=False))
    assert set(_flat(got.master).values()) == {(None,)}


@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-76b",
                                  "olmoe-1b-7b", "whisper-tiny"])
def test_build_model_under_a_plan_takes_its_tp(arch, tp):
    mesh = MeshShape(("data", "model"), (1, tp))
    plan = pt_sharding.logical_rules(mesh, mode="train")
    cfg = pt_get_config(arch)
    model = pt_build_model(cfg, plan, device="cpu")
    assert model.dims.tp == tp
    assert model.dims.layout == HeadLayout.make(cfg.attn, tp)
    jdims = jx_build_model(jx_get_config(arch),
                           jx_sharding.logical_rules(mesh, mode="train")).dims
    assert dataclasses.asdict(model.dims.layout) == \
        dataclasses.asdict(jdims.layout)
    assert model.dims.vocab_pad == jdims.vocab_pad


def test_block_table_is_the_same_at_tp_1_and_2():
    cfg = dataclasses.replace(reduced(pt_get_config("qwen3-1.7b")),
                              attention_impl="chunked")
    shape = ShapeConfig("t", "train", 32, 8)
    t1 = build_block_table(pt_build_model(cfg, device="cpu"), shape)
    plan = pt_sharding.logical_rules(MESHES["host_4x2"], mode="train")
    t2 = build_block_table(pt_build_model(cfg, plan, device="cpu"), shape)
    assert t1.names == t2.names
    assert t1.step_uow() == t2.step_uow()
    np.testing.assert_allclose(t1.costs(), t2.costs(), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("shard_seq", [False, True])
def test_cache_specs_equal_the_jax_package(arch, shard_seq):
    from repro.configs import reduced as jx_reduced
    from repro.models import kvcache as jx_kv
    from repro_torch.models import kvcache as pt_kv
    m = MESHES["host_4x2"]
    pplan = pt_sharding.logical_rules(m, mode="serve", shard_seq=shard_seq)
    jplan = jx_sharding.logical_rules(m, mode="serve", shard_seq=shard_seq)
    pcache = pt_build_model(reduced(pt_get_config(arch)),
                            device="cpu").init_cache(2, 16)
    jcache = jx_build_model(jx_reduced(jx_get_config(arch))).init_cache(2, 16)
    assert sorted(pcache) == sorted(jcache)
    assert pt_kv.CACHE_AXES == jx_kv.CACHE_AXES
    got = pt_kv.cache_specs(pcache, pplan)
    want = jx_kv.cache_specs(jcache, jplan)
    assert {k: tuple(v) for k, v in want.items()} == got
    with pt_sharding.use_rules(pplan):
        sharded = pt_kv.shard_cache(pcache)
    assert all(sharded[k] is pcache[k] for k in pcache)


def test_sharded_loss_and_grads_on_a_one_rank_mesh(one_rank_group):
    """The DTensor path (shard-local attention, embedding and CE, the
    `shard(...)` constraints) at world size 1 gives the plain path's loss
    and gradients."""
    from repro_torch.models.layers import tree_leaves, tree_map
    mesh = make_host_mesh(model=1, device="cpu")
    plan = pt_sharding.logical_rules(mesh, mode="train")
    cfg = dataclasses.replace(reduced(pt_get_config("qwen3-1.7b")),
                              attention_impl="chunked")
    model = pt_build_model(cfg, plan, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))).int()
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}

    def loss_and_grads(p, b):
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        with pt_sharding.use_rules(plan), pt_sharding.sharded_region(p):
            loss, _ = model.loss(p, b)
            grads = torch.autograd.grad(loss, leaves)
        return (pt_sharding.to_plain(loss.detach()),
                [pt_sharding.to_plain(g) for g in grads])

    want_loss, want_grads = loss_and_grads(params, batch)
    sp = pt_sharding.distribute(
        tree_map(lambda t: t.detach().clone(), params),
        pt_sharding.params_shardings(mesh, plan, model.axes()))
    sb = pt_sharding.distribute_batch(batch, plan)
    got_loss, got_grads = loss_and_grads(sp, sb)
    assert not isinstance(got_loss, type(sp["final_norm"]["scale"]))
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-6, atol=0)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("module", ["attention", "transformer", "moe", "ssm",
                                    "encdec", "decode", "kvcache"])
def test_shard_call_sites_match_the_reference(module):
    """Each model module calls `shard(...)` where the reference does: the
    same number of calls, with the same logical axes, in the same order."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent / "src"

    def calls(pkg):
        tree = ast.parse((root / pkg / "models" / f"{module}.py").read_text())
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "shard":
                out.append((node.lineno, tuple(
                    a.value if isinstance(a, ast.Constant) else "*"
                    for a in node.args[1:])))
        return [axes for _, axes in sorted(out)]
    assert calls("repro_torch") == calls("repro")
