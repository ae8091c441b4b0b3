"""The port's Checkpointer: the twins of `tests/test_checkpoint.py` (atomic
commit, checksum, keep-N GC, async save, exact resume, restore with a dtype
cast), and the files of the JAX package: the same key paths, the JAX
`Trainer`'s checkpoint restores into the port's `TrainState`, and one port
step from it equals one JAX step (2e-4, `tests/test_models.py`'s f32
tolerance; key paths, the meter and the step byte-equal)."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten as j_flatten
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer

TOL = 2e-4


def _tree(seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": scale * torch.randn((8, 4), generator=g)},
            "b": torch.arange(5, dtype=torch.int32),
            "step": torch.tensor(3)}


def _cfg():
    return dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               attention_impl="chunked", ssm_impl="chunked")


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = _tree()
    ck.save(5, t)
    restored, _ = ck.restore(_tree(seed=1))
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert ck.latest_step() == 5


def test_keep_n_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
    assert ck.all_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    t = _tree()
    saved = t["a"]["w"].clone()
    ck.save(7, t, extra={"note": "x"})
    t["a"]["w"].add_(1.0)           # in-place update after the snapshot
    ck.wait()
    restored, extra = ck.restore(t)
    assert extra == {"note": "x"}
    assert torch.equal(restored["a"]["w"], saved)


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree())
    p = os.path.join(str(tmp_path), "step_00000001", "arrays_p0.npz")
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(data[:100] + b"\x00" * 50 + data[150:])
    with pytest.raises(Exception):
        ck.restore(_tree())


def test_partial_write_never_committed(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), ".tmp-step_00000002-0"))
    assert ck.latest_step() == 1


def test_restore_with_dtype_cast(tmp_path):
    """Into a template of another dtype (f32 -> bf16 and back, bf16 stored
    as the raw 2-byte values that the JAX package writes)."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"w": torch.ones((4, 4)) / 3})
    restored, _ = ck.restore({"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], (torch.ones((4, 4)) / 3).bfloat16())
    ck.save(2, restored)
    back, _ = ck.restore({"w": torch.zeros((4, 4))})
    assert back["w"].dtype == torch.float32
    assert torch.equal(back["w"], restored["w"].float())


def test_resume_matches_uninterrupted(tmp_path):
    """Checkpoint/restart at step 3 reproduces the uninterrupted run exactly
    (stateless data cursor + saved opt state and meter)."""
    kw = dict(seq_len=16, batch=2, ckpt_dir=str(tmp_path / "a"),
              ckpt_every=3, device="cpu")
    full = Trainer(_cfg(), **kw).run(5)
    t2 = Trainer(_cfg(), **kw)
    resumed = t2.run(5)                # restores step 3, runs 3..5
    assert int(resumed.step) == 5
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(full.opt.nu), tree_leaves(resumed.opt.nu)):
        assert torch.equal(a, b)
    assert int(full.meter["uow"]) == int(resumed.meter["uow"])
    assert t2.meter_reading["steps"] == 5


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX Trainer's run of 2 steps with a checkpoint at step 2, and the
    same trainer's third step."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jt = JTrainer(jreduced(jget("qwen3-1.7b")), seq_len=16, batch=2,
                  ckpt_dir=d, ckpt_every=2, donate=False)
    at2 = jt.run(2)
    at3 = jt.run(3, state=at2)
    return d, at2, jt.metrics_history[-1], jax.tree.map(np.asarray, at3)


def test_key_paths_are_the_jax_packages(jax_checkpoint, tmp_path):
    d, at2, _, _ = jax_checkpoint
    want = j_flatten(at2)
    state = Trainer(_cfg(), seq_len=16, batch=2, device="cpu").init_state()
    got = _flatten(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype or \
            got[k].dtype.kind == want[k].dtype.kind == "V", k
    no_master = Trainer(_cfg(), seq_len=16, batch=2, device="cpu",
                        opt=AdamWConfig(use_master=False),
                        instrument=False).init_state()
    assert sorted(_flatten(no_master)) == sorted(
        k for k in want if not k.startswith(".meter"))
    assert _flatten(no_master)[".opt/.master/embed/embedding"].shape == (0,)


def test_jax_trainer_checkpoint_restores_into_the_port(jax_checkpoint):
    """Every leaf restored equal (params, moments, master, step, rng, the
    meter's limbs into one counter); one port step from it equals the JAX
    Trainer's next step."""
    d, at2, jmet, at3 = jax_checkpoint
    tr = Trainer(_cfg(), seq_len=16, batch=2, ckpt_dir=d, device="cpu")
    state, _ = tr.ckpt.restore(tr.init_state())
    want = {k: np.asarray(v) for k, v in j_flatten(at2).items()}
    got = _flatten(state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(p.requires_grad for p in tree_leaves(state.params))
    state, metrics, _ = tr._step_fn(state, tr._device_batch(2))
    assert abs(metrics["loss"].item() - jmet["loss"]) <= TOL * jmet["loss"]
    assert int(state.step) == int(at3.step) == 3
    got = _flatten(state)
    for k, w in j_flatten(at3).items():
        if k.startswith(".params") or k.startswith(".opt/.master"):
            err = np.abs(got[k] - w).max() / max(1.0, np.abs(w).max())
            assert err <= TOL, (k, err)
    # block executions are the same program's; the unit of work is the IR's
    np.testing.assert_array_equal(got[".meter/counts"], w_counts := np.asarray(
        at3.meter["counts"]))
    assert int(got[".meter/steps"]) == 3 and w_counts.sum() > 0
