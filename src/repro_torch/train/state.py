# Counterpart of src/repro/train/state.py; nothing of it is left unported.
# `jax.jit` and its donated buffers become a step that updates the state in
# place; `init_train_state` also takes ready parameters (converted from the
# JAX package, or restored).  A state whose parameters are DTensors (put on a
# mesh by `distributed.sharding.distribute`) takes the same step: its loss
# and gradients run in `sharded_region`, and the loss and the aux values come
# back as plain tensors (full on every rank), so the meter stays plain.  With
# `microbatch` > 1 the f32 accumulators keep each leaf's placements, and the
# batch is split so that every rank keeps the rows it owns
# (`split_microbatches`).  `TrainStep` also hands its three parts to the
# dry-run, which prices them one by one (`launch/dryrun.py`).
"""Train state + step construction (the Trainer wires I/O).

``TrainState.rng`` is the reference's PRNG key carried as an opaque uint32[2]
numpy array.  The dense and SSM losses draw no random numbers; an MoE loss
with ``router_jitter > 0`` draws its jitter from a ``torch.Generator`` seeded
from ``(rng, step)`` on the model's device (``step_generator``), where the
reference folds the step into its key: deterministic per (seed, step), with
other values than threefry's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.meter import init_meter, static_increment, tick_step
from repro_torch.core.registry import BlockTable
from repro_torch.distributed.sharding import sharded_region, to_plain
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model_zoo import Model
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     init_opt_state)


class TrainState(NamedTuple):
    step: torch.Tensor                      # int32 scalar on the device
    params: Any
    opt: OptState
    rng: np.ndarray                         # uint32[2], opaque
    meter: Optional[Dict[str, torch.Tensor]]


def init_train_state(model: Model, init: Union[torch.Generator, Dict[str, Any]],
                     opt_cfg: AdamWConfig,
                     table: Optional[BlockTable] = None, *,
                     rng: Optional[np.ndarray] = None) -> TrainState:
    """``init``: a generator to draw the parameters from (``model.init``), or
    ready parameters on the model's device, which the state then owns."""
    if isinstance(init, torch.Generator):
        params = model.init(init)
        if rng is None:
            rng = np.asarray([0, init.initial_seed() & 0xFFFFFFFF], np.uint32)
    else:
        params = model.params_on_device(init)
    for p in tree_leaves(params):
        if not p.is_floating_point():
            raise NotImplementedError(
                f"weight_quant={model.cfg.weight_quant!r}: a train step "
                "differentiates every parameter, and an integer payload has "
                "no gradient (weight-only quantization serves; the "
                "reference's value_and_grad refuses integer leaves too)")
        p.requires_grad_(True)
    opt = init_opt_state(params, opt_cfg)
    meter = init_meter(table, model.device) if table is not None else None
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    rng = np.zeros(2, np.uint32) if rng is None else np.asarray(rng, np.uint32)
    return TrainState(step, params, opt, rng, meter)


def step_generator(rng: np.ndarray, step: int, device) -> torch.Generator:
    """The step's jitter stream: a generator on ``device`` seeded from the
    state's key and the step (the reference's ``fold_in(rng, step)``)."""
    seed = np.random.SeedSequence(
        [int(x) for x in np.asarray(rng, np.uint32)] + [int(step)]
    ).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def split_microbatches(batch: Dict[str, torch.Tensor], microbatch: int
                       ) -> List[Dict[str, torch.Tensor]]:
    """``batch`` cut into ``microbatch`` slices of equal size along the rows.

    Each rank's own rows are cut into contiguous parts, and slice ``i`` is
    every rank's part ``i``.  On one rank (a plain tensor) that is the
    reference's contiguous split (``src/repro/train/state.py``); on a mesh
    the rows of a slice are strided over the ranks, so no rank moves or
    computes a row it does not own (a DTensor ``reshape`` of a ``Shard(0)``
    batch would redistribute it).  The mean gradient over equal slices is
    the same for any such split.  A rank whose rows do not split evenly
    raises, naming the leaf."""
    parts = {}
    for name, x in batch.items():
        local = x.to_local() if isinstance(x, DTensor) else x
        rows = local.shape[0]
        if rows % microbatch:
            raise ValueError(f"{name}: {rows} rows on each rank do not "
                             f"split into {microbatch} microbatches")
        cut = local.reshape(microbatch, rows // microbatch,
                            *local.shape[1:]).unbind(0)
        if isinstance(x, DTensor):
            shape = torch.Size((x.shape[0] // microbatch, *x.shape[1:]))
            cut = [DTensor.from_local(c, x.device_mesh, x.placements,
                                      run_check=False, shape=shape,
                                      stride=c.stride()) for c in cut]
        parts[name] = cut
    return [{k: v[i] for k, v in parts.items()} for i in range(microbatch)]


@dataclasses.dataclass
class TrainStep:
    """The train step: ``step(state, batch) -> (state, metrics, aux)``, the
    state updated in place.  With ``microbatch`` > 1 it runs ``start``, then
    ``accumulate`` once per slice, then ``finish``; the dry-run traces the
    three apart and counts ``accumulate`` ``microbatch`` times."""
    grads_of: Callable
    finish: Callable
    microbatch: int
    jitter: bool
    device: Any

    def rng(self, state: "TrainState"):
        # reading the step is a device sync: only a loss that draws does it
        return (step_generator(state.rng, int(state.step), self.device)
                if self.jitter else None)

    def start(self, state: "TrainState", batch: Dict[str, torch.Tensor]):
        """(slices, accumulators): f32 zeros with each leaf's placements
        (``zeros_like`` keeps a DTensor's), the loss's and the aux's."""
        gacc = [torch.zeros_like(p, dtype=torch.float32)
                for p in tree_leaves(state.params)]
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        return split_microbatches(batch, self.microbatch), (gacc, loss, {})

    def accumulate(self, state: "TrainState", mslice, rng, acc):
        """One slice's loss and gradients added into ``acc``."""
        gacc, loss, aux = acc
        l, a, g = self.grads_of(state.params, mslice, rng)
        for ai, gi in zip(gacc, g):
            ai.add_(gi.float() / self.microbatch)
        del g
        return (gacc, loss + l / self.microbatch,
                {k: aux.get(k, 0) + v for k, v in a.items()})

    def __call__(self, state: "TrainState", batch: Dict[str, torch.Tensor]):
        rng = self.rng(state)
        if self.microbatch > 1:
            slices, acc = self.start(state, batch)
            for mslice in slices:
                acc = self.accumulate(state, mslice, rng, acc)
            grads, loss, aux = acc
        else:
            loss, aux, grads = self.grads_of(state.params, batch, rng)
        return self.finish(state, grads, loss, aux)


def make_train_step(model: Model, opt_cfg: AdamWConfig, lr_fn: Callable,
                    *, table: Optional[BlockTable] = None,
                    microbatch: int = 1,
                    instrument: bool = True) -> Callable:
    """Build the train step (a `TrainStep`): (state, batch) -> (state,
    metrics, aux); the state is updated in place and returned.

    ``microbatch`` > 1 splits the global batch into that many accumulation
    slices (f32 accumulators; `split_microbatches`).  When ``instrument``
    and a BlockTable is given
    the WorkMeter hook (paper §III-C1) runs inside the step."""
    tick = instrument and table is not None
    inc = static_increment(table, "default", model.device) if tick else None
    moe = model.cfg.moe
    jitter = moe is not None and moe.router_jitter > 0

    def grads_of(params, batch, rng):
        leaves = tree_leaves(params)
        with torch.enable_grad(), sharded_region(params):
            loss, aux = model.loss(params, batch, rng=rng)
            grads = torch.autograd.grad(loss, leaves)
        return (to_plain(loss.detach()),
                {k: to_plain(v.detach()) for k, v in aux.items()}, grads)

    def unflatten(params, leaves):
        it = iter(leaves)

        def walk(tree):
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            return next(it)
        return walk(params)

    def finish(state: TrainState, grads, loss, aux):
        """The AdamW update, the meter's tick and the step's count."""
        lr = lr_fn(state.step)
        _, _, om = adamw_update(state.params,
                                unflatten(state.params, grads), state.opt,
                                opt_cfg, lr)
        if tick and state.meter is not None:
            tick_step(state.meter, table, aux, inc=inc)
        state.step.add_(1)
        return state, {"loss": loss, **om}, aux

    return TrainStep(grads_of, finish, microbatch, jitter, model.device)
