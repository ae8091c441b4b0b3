# Counterpart of src/repro/core/meter.py; nothing of it is left unported.
# The unit-of-work counter is one int64 where the reference keeps two uint32
# limbs (jaxpr integers are 32-bit); a checkpoint still holds the limbs
# (`meter_to_limbs`, `meter_from_limbs`), so that the two packages read each
# other's checkpoints.  `meter_psum` takes a process group (or a DeviceMesh
# dim) where the reference takes a `shard_map` axis name.
"""WorkMeter: the in-step hook state (paper §III-C1).

The meter is a small dict of device tensors that the train step updates in
place.  Each step the hook adds the static per-step block counts and the
dynamic entries to the block-count vector and the step's unit of work to the
global counter.  The static additions are made once, on the device
(``static_increment``), so a tick copies nothing from the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.registry import BlockTable
from repro_torch.distributed.sharding import process_group
from repro_torch.device import DeviceLike, resolve_device

METER_KEYS = ("uow", "counts", "steps")


def init_meter(table: BlockTable, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "uow": torch.zeros((), dtype=torch.int64, device=dev),
        "counts": torch.zeros((table.n_blocks,), dtype=torch.int32,
                              device=dev),
        "steps": torch.zeros((), dtype=torch.int32, device=dev),
    }


def is_meter(tree: Any) -> bool:
    return isinstance(tree, dict) and set(tree) == set(METER_KEYS)


def static_increment(table: BlockTable, kind: str = "default",
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """What every step of ``kind`` adds, as device tensors made once."""
    dev = resolve_device(device)
    return {
        "counts": torch.as_tensor(table.step_counts(kind),
                                  dtype=torch.int32).to(dev),
        "uow": torch.tensor(int(round(table.step_uow(kind))),
                            dtype=torch.int64).to(dev),
    }


def meter_psum(meter: Dict[str, torch.Tensor], group=None
               ) -> Dict[str, torch.Tensor]:
    """Cross-rank aggregation: every counter summed over ``group`` (a process
    group or a 1-D DeviceMesh; default: the world) by an all-reduce, into
    new tensors; the sync cost of hooks.  Every rank of the group must call
    it."""
    pg = process_group(group)
    out = {}
    for k, v in meter.items():
        t = v.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=pg)
        out[k] = t
    return out


def meter_value(meter) -> int:
    return int(meter["uow"])


def tick_step(meter: Dict[str, torch.Tensor], table: BlockTable,
              aux: Optional[Dict[str, torch.Tensor]] = None,
              kind: str = "default", *,
              inc: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """The per-step hook: O(n_blocks) integer adds on the device, in place.
    ``inc``: the step's ``static_increment`` (made here if not given)."""
    if inc is None:
        inc = static_increment(table, kind, meter["counts"].device)
    counts = meter["counts"]
    counts.add_(inc["counts"])
    if aux:
        for i, b in enumerate(table.blocks):
            if b.virtual and b.dyn_key and b.dyn_key in aux:
                v = aux[b.dyn_key]
                val = v[b.dyn_index] if (b.dyn_index >= 0 and v.ndim) else v
                counts[i].add_(val.detach().to(torch.int32))
    meter["uow"].add_(inc["uow"])
    meter["steps"].add_(1)
    return meter


def meter_to_limbs(meter: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The reference's on-disk meter: the counter as two uint32 limbs."""
    uow = meter_value(meter)
    return {"uow_lo": np.asarray(uow & 0xFFFFFFFF, np.uint32),
            "uow_hi": np.asarray((uow >> 32) & 0xFFFFFFFF, np.uint32),
            "counts": meter["counts"].cpu().numpy().astype(np.int32),
            "steps": np.asarray(int(meter["steps"]), np.int32)}


def meter_from_limbs(arrays: Dict[str, np.ndarray], device: DeviceLike
                     ) -> Dict[str, torch.Tensor]:
    uow = (int(arrays["uow_hi"]) << 32) | int(arrays["uow_lo"])
    dev = resolve_device(device)
    return {
        "uow": torch.tensor(uow, dtype=torch.int64).to(dev),
        "counts": torch.as_tensor(np.asarray(arrays["counts"], np.int32)
                                  ).to(dev),
        "steps": torch.tensor(int(arrays["steps"]), dtype=torch.int32).to(dev),
    }


def read_meters(meters: Sequence[Dict[str, torch.Tensor]]
                ) -> List[Dict[str, Any]]:
    """Batched host readback of device meters: ONE device transfer for the
    whole batch, instead of one sync per value per meter.  Publishes the
    unit-of-work totals of the *last* meter in the batch to the ``meter.*``
    gauges (gauges are last-write-wins; the final reading is the run
    total)."""
    if not meters:
        return []
    flat = torch.cat([torch.cat([m["uow"].reshape(1),
                                 m["steps"].reshape(1).long(),
                                 m["counts"].long()])
                      for m in meters]).cpu().numpy()   # single device sync
    out: List[Dict[str, Any]] = []
    at = 0
    for m in meters:
        n = m["counts"].numel()
        out.append({"uow": np.uint64(flat[at]), "steps": int(flat[at + 1]),
                    "counts": flat[at + 2:at + 2 + n].astype(np.int32)})
        at += 2 + n
    m = obs.metrics()
    m.count("meter.readbacks")
    last, steps = out[-1], out[-1]["steps"]
    m.record("meter.uow_total", float(last["uow"]))
    m.record("meter.steps", steps)
    if steps:
        m.record("meter.uow_per_step", int(last["uow"]) / steps)
    return out


def read_meter(meter) -> Dict[str, Any]:
    """Host-side readback of one device meter (one device sync — delegates
    to the batched :func:`read_meters`)."""
    return read_meters([meter])[0]


def materialize_dyn(steps: List, *, chunk: int = 512) -> int:
    """Convert device-resident dynamic aux tensors in a ``(kind, dyn)`` step
    log to host numpy arrays, in place, with one device transfer per
    ``chunk`` of values (the training hot loop never waits for them).
    Idempotent: host arrays pass through untouched.  Returns the number of
    arrays fetched."""
    pend = [(i, k) for i, (_, dyn) in enumerate(steps) if dyn
            for k, v in dyn.items() if isinstance(v, torch.Tensor)]
    for lo in range(0, len(pend), chunk):
        part = pend[lo:lo + chunk]
        vals = [steps[i][1][k] for i, k in part]
        flat = torch.cat([v.detach().reshape(-1).double()
                          for v in vals]).cpu().numpy()      # one sync
        at = 0
        for (i, k), v in zip(part, vals):
            kind, dyn = steps[i]
            dyn = dict(dyn)
            a = flat[at:at + v.numel()].reshape(tuple(v.shape))
            dyn[k] = a.astype(str(v.dtype).replace("torch.", ""))
            at += v.numel()
            steps[i] = (kind, dyn)
    if pend:
        obs.metrics().count("meter.dyn_fetched", len(pend))
    return len(pend)
