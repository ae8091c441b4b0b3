"""The port's work meter (one int64 counter on the device) against the JAX
package's (two uint32 limbs): equal counts, steps and unit of work after
every tick, across the 2**32 carry; the checkpoint's limbs round-trip; the
batched readbacks publish the same gauges."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meter as JM
from repro.core import registry as JR
from repro_torch import obs
from repro_torch.core import meter as PM
from repro_torch.core import registry as PR


def _table(mod, cost: float):
    """A dense-like program plus a virtual block fed by the aux."""
    return mod.BlockTable(
        [mod.BlockDef("embed", 3.0), mod.BlockDef("attn", cost),
         mod.BlockDef("mlp", 260.0), mod.BlockDef("head", 75.0),
         mod.BlockDef("expert_tok_1", 0.0, virtual=True,
                      dyn_key="expert_tokens", dyn_index=1)],
        [mod.Segment((0,), 1), mod.Segment((1, 2), 3), mod.Segment((3,), 1)])


@pytest.mark.parametrize("cost", [120.0, 7.5e8],
                         ids=["small", "past-2**32"])
def test_tick_step_and_meter_value_match_the_jax_package(cost):
    jt, pt = _table(JR, cost), _table(PR, cost)
    jm, pm = JM.init_meter(jt), PM.init_meter(pt, "cpu")
    inc = PM.static_increment(pt, device="cpu")
    for step in range(5):
        aux = np.asarray([step, 2 * step + 1, 0], np.int32)
        jm = JM.tick_step(jm, jt, {"expert_tokens": jnp.asarray(aux)})
        PM.tick_step(pm, pt, {"expert_tokens": torch.from_numpy(aux)},
                     inc=inc if step % 2 else None)
        assert PM.meter_value(pm) == JM.meter_value(jm)
        np.testing.assert_array_equal(pm["counts"].numpy(),
                                      np.asarray(jm["counts"]))
        assert int(pm["steps"]) == int(jm["steps"]) == step + 1
    assert PM.meter_value(pm) == 5 * int(round(pt.step_uow()))
    if cost > 1e8:
        assert PM.meter_value(pm) > 2 ** 32


def test_limbs_round_trip_and_equal_the_jax_layout():
    jt, pt = _table(JR, 7.5e8), _table(PR, 7.5e8)
    jm, pm = JM.init_meter(jt), PM.init_meter(pt, "cpu")
    for _ in range(3):
        jm = JM.tick_step(jm, jt)
        PM.tick_step(pm, pt)
    limbs = PM.meter_to_limbs(pm)
    assert sorted(limbs) == sorted(jm)
    for k, v in limbs.items():
        assert v.dtype == np.asarray(jm[k]).dtype
        np.testing.assert_array_equal(v, np.asarray(jm[k]))
    back = PM.meter_from_limbs(limbs, "cpu")
    assert PM.is_meter(back) and PM.meter_value(back) == PM.meter_value(pm)
    assert torch.equal(back["counts"], pm["counts"])


def test_read_meters_is_one_batch_and_sets_the_gauges():
    pt = _table(PR, 120.0)
    meters = [PM.init_meter(pt, "cpu") for _ in range(3)]
    for i, m in enumerate(meters):
        for _ in range(i + 1):
            PM.tick_step(m, pt)
    before = obs.metrics().value("meter.readbacks") or 0
    out = PM.read_meters(meters)
    assert [o["steps"] for o in out] == [1, 2, 3]
    assert [int(o["uow"]) for o in out] == [
        n * int(round(pt.step_uow())) for n in (1, 2, 3)]
    assert out[2]["counts"].dtype == np.int32
    assert obs.metrics().value("meter.readbacks") == before + 1
    assert obs.metrics().value("meter.steps") == 3
    assert PM.read_meters([]) == []


def test_materialize_dyn_fetches_tensors_in_place():
    steps = [("default", {"expert_tokens": torch.tensor([1, 2], dtype=torch.int32),
                          "dropped_tokens": torch.tensor(3)}),
             ("default", None),
             ("default", {"expert_tokens": np.asarray([4, 5], np.int32)})]
    assert PM.materialize_dyn(steps, chunk=1) == 2
    assert steps[0][1]["expert_tokens"].dtype == np.int32
    np.testing.assert_array_equal(steps[0][1]["expert_tokens"], [1, 2])
    assert int(steps[0][1]["dropped_tokens"]) == 3
    assert steps[1] == ("default", None)
    assert PM.materialize_dyn(steps) == 0
