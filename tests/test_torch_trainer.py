"""The port's `Trainer` and what it stands on, on the CPU at the reduced size
(f32): microbatch accumulation, the train table's traced grad/fwd scale, the
one-`unbind` split of the stacked layer leaves, the interval profile against
the JAX `Trainer`'s, the replay runner and the launcher."""
import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_port import SSM_ARCHS, to_np
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.train import Trainer as JTrainer
from repro_torch.configs import get_config, reduced
from repro_torch.core import blocks_lm as PB
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import AdamWConfig, constant
from repro_torch.train import Trainer
from repro_torch.train.state import init_train_state, make_train_step
from test_torch_train import _batch, _flat, _train_cfg

LR = 1e-3
ARCHS = {"qwen3-1.7b": {}, **SSM_ARCHS}


def test_microbatch_equals_single_shot():
    """`microbatch=2` (f32 accumulators) against one shot of the whole
    batch, as `tests/test_models.py::test_microbatch_equals_full_batch`."""
    cfg = _train_cfg(reduced(get_config("qwen3-1.7b")))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, batch = _batch(cfg, 0, 16, 4)
    out = {}
    for mb in (1, 2):
        state = init_train_state(
            model, {k: v.detach().clone() for k, v in _flat(params).items()}
            and _clone(params), AdamWConfig(lr=LR))
        step = make_train_step(model, AdamWConfig(lr=LR), constant(LR),
                               microbatch=mb, instrument=False)
        state, metrics, aux = step(state, batch)
        out[mb] = (state, metrics, aux)
    (s1, m1, a1), (s2, m2, a2) = out[1], out[2]
    assert abs(m1["loss"].item() - m2["loss"].item()) < 1e-4
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(to_np(b), to_np(a), rtol=2e-4, atol=2e-5)
    # the aux of the slices is summed, as the reference's scan does
    assert a2["nll_mean"].item() == pytest.approx(2 * a1["nll_mean"].item(),
                                                  rel=1e-4)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_scale_is_traced_not_the_fallback(arch):
    """The train table scales block costs by the traced grad/fwd ratio of
    the loss (rematerialised forward included), not the fallback of 3.0."""
    cfg = _train_cfg(get_config(arch))
    scale = PB.train_scale_traced(cfg)
    assert scale > 1.0 and scale != 3.0
    assert PB._train_scale(build_model(cfg, device="meta")) == scale
    if cfg.family == "dense":
        no_remat = PB.train_scale_traced(dataclasses.replace(cfg,
                                                             remat="none"))
        assert 1.0 < no_remat < scale


def test_training_forward_splits_each_stacked_leaf_once():
    """The grad graph takes each stacked layer leaf apart with one `unbind`
    (backward: one `stack`), not with a `select` per layer, whose backward
    would build a zero gradient the size of the whole leaf for every
    layer."""
    from repro_torch.core.unit_of_work import op_name, trace_graph
    from repro_torch.models import layers as L
    cfg = _train_cfg(reduced(get_config("qwen3-1.7b"), n_layers=3))
    m = build_model(cfg, device="meta")
    sp = L.map_specs(lambda s: torch.empty(s.shape, device="meta"
                                           ).requires_grad_(), m.specs())
    toks = torch.empty((2, 16), dtype=torch.int64, device="meta")

    def grad(p, t):
        with torch.enable_grad():
            loss = m.loss(p, {"tokens": t, "labels": t})[0]
            return torch.autograd.grad(loss, L.tree_leaves(p))

    ops = collections.Counter(
        op_name(n) for n in trace_graph(grad, sp, toks).graph.nodes
        if n.op == "call_function")
    n_stacked = len(L.tree_leaves(m.specs()["layers"]))
    assert ops["unbind"] == ops["stack"] == n_stacked
    assert ops["select_backward"] < n_stacked


def test_remat_does_not_change_the_gradients():
    """`remat="full"` by layer, by groups of 2 layers (`remat_group`) and
    `remat="none"` give the same loss and gradients (the recomputed forward
    is the same computation)."""
    base = _train_cfg(reduced(get_config("qwen3-1.7b"), n_layers=4))
    params = build_model(base, device="cpu").init(
        torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    _, batch = _batch(base, 0, 16, 2)
    out = []
    for kw in ({}, {"remat_group": 2}, {"remat": "none"}):
        m = build_model(dataclasses.replace(base, **kw), device="cpu")
        loss = m.loss(params, batch)[0]
        out.append((loss, torch.autograd.grad(loss, leaves)))
    for loss, grads in out[1:]:
        assert loss.item() == out[0][0].item()
        for a, b in zip(grads, out[0][1]):
            assert torch.allclose(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Trainer, profile, launcher
# ---------------------------------------------------------------------------


def test_trainer_profile_matches_the_jax_trainer():
    """`Trainer.run` then `profile()`: the interval boundaries in step space,
    the BBVs (block executions) and the block names and program are the
    JAX Trainer's, byte for byte; the unit-of-work counts are IR-specific.
    The parallel finalize equals the serial one; the meter read at the end
    of the run holds steps x the table's counts."""
    jcfg = jreduced(jget("qwen3-1.7b"))
    pcfg = _train_cfg(reduced(get_config("qwen3-1.7b")))
    kw = dict(seq_len=16, batch=2, interval_steps=2.0)
    jt = JTrainer(jcfg, **kw)
    jt.run(7)
    jprof = jt.profile()
    pt = Trainer(pcfg, device="cpu", **kw)
    state = pt.run(7)
    pprof = pt.profile()
    assert pprof.table.names == jprof.table.names
    assert [(s.pattern, s.repeat) for s in pprof.table.program] == \
        [(s.pattern, s.repeat) for s in jprof.table.program]
    assert pprof.n_intervals == jprof.n_intervals == 3
    for a, b in zip(pprof.intervals, jprof.intervals):
        assert (a.start_step, a.end_step) == (b.start_step, b.end_step)
        assert a.bbv.tobytes() == b.bbv.tobytes()
    par = pt.profile(max_workers=2, chunk_steps=2)
    assert [(i.start_uow, i.end_uow) for i in par.intervals] == \
        [(i.start_uow, i.end_uow) for i in pprof.intervals]
    assert pt.meter_reading["steps"] == 7 == int(state.step)
    np.testing.assert_array_equal(pt.meter_reading["counts"],
                                  7 * pt.table.step_counts())
    np.testing.assert_array_equal(pt.meter_reading["counts"],
                                  np.asarray(jt.meter_reading["counts"]))
    assert len(pt.watchdog_report().step_times) == 7


def test_runner_replays_the_trainer():
    """`make_runner`: a fresh state at step 0 and the same steps give the
    same parameters as `Trainer.run`; `measure_full_run` times it."""
    from repro_torch.core.replay import measure_full_run
    cfg = _train_cfg(reduced(get_config("qwen3-1.7b")))
    tr = Trainer(cfg, seq_len=16, batch=2, device="cpu")
    want = tr.run(3)
    runner = tr.make_runner()
    state = runner.reset(0)
    for s in range(3):
        state = runner.run_step(state, s)
    runner.sync(state)
    for a, b in zip(tree_leaves(want.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert measure_full_run(runner, 2) > 0


def _state_leaves(state):
    """Every tensor of a train state by name, and its key."""
    out = {f"params{k}": v for k, v in _flat(state.params).items()}
    for name in ("mu", "nu", "master"):
        out.update({f"{name}{k}": v
                    for k, v in _flat(getattr(state.opt, name)).items()})
    out.update({"opt.step": state.opt.step, "step": state.step,
                **{f"meter/{k}": v for k, v in (state.meter or {}).items()}})
    return out, state.rng


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_reset_copies_a_state_bit_equal_to_a_fresh_draw(arch):
    """`init_state` draws the parameters once and keeps them on the host;
    every later reset copies them in.  The state it builds is, leaf by leaf
    and bit for bit, the one a fresh draw from the seed builds, also after
    steps have updated earlier states in place."""
    cfg = _train_cfg(reduced(get_config(arch)))
    tr = Trainer(cfg, seq_len=16, batch=2, device="cpu")
    fresh = init_train_state(tr.model, torch.Generator().manual_seed(0),
                             tr.opt_cfg, tr.table)
    want, want_rng = _state_leaves(fresh)
    tr.run(2, state=tr.init_state())          # the draw, stepped in place
    runner = tr.make_runner()
    for _ in range(2):
        state = runner.reset(0)
        got, rng = _state_leaves(state)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        assert got["params/embed/embedding"].requires_grad
        np.testing.assert_array_equal(rng, want_rng)
        runner.run_step(state, 0)             # moves this copy only
    assert tr._init_params is not None


def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    from repro_torch.core.profile_store import load_profile
    from repro_torch.launch import train
    out = train.main(["--arch", "mamba2-780m", "--reduced", "--steps", "3",
                      "--seq-len", "16", "--batch", "2", "--device", "cpu",
                      "--profile-out", str(tmp_path / "prof")])
    printed = json.loads(capsys.readouterr().out)
    assert printed["final_loss"] == out["final_loss"]
    assert np.isfinite(printed["final_loss"])
    # the profile flags are ported: the run's profile is written
    assert load_profile(str(tmp_path / "prof")).n_steps == 3
