# Counterpart of src/repro/train/trainer.py; nothing of it is left unported
# but the `donate` switch: the step always updates the state in place, so
# `make_runner`'s reset builds a fresh state every time, from initial
# parameters drawn once per trainer and kept on the host.  The default corpus
# carries the enc-dec family's frames and the VLM's patches, as the
# reference's does.
"""Instrumented trainer: the paper's "interval analysis executable" is this
loop with profiling on.  Features:

- WorkMeter hooks inside the step + host-side IntervalBuilder (per-step
  dynamic signature entries from the loss aux),
- microbatch gradient accumulation, in-place optimizer updates,
- atomic async checkpointing + exact resume (stateless data cursor),
- step watchdog: straggler detection/logging (slow-step quarantine list),
- replay support: ``make_runner()`` exposes the run as a StepRunner so a
  replay engine can validate nuggets on this platform.  Its resets copy the
  initial parameters, drawn once and kept in host memory, back onto the
  device instead of drawing them again (the values are the same).

It trains with the chunked attention and SSD (the JAX package's training
defaults): the CUDA kernels have no backward, so a config that names them
is refused here rather than switched silently.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.blocks_lm import build_block_table
from repro_torch.core.intervals import IntervalBuilder, Profile
from repro_torch.core.meter import materialize_dyn, read_meter
from repro_torch.core.registry import BlockTable
from repro_torch.core.replay import SimpleRunner, sync_device
from repro_torch.device import DeviceLike
from repro_torch.models.layers import tree_map
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import constant
from repro_torch.train.state import (TrainState, init_train_state,
                                     make_train_step)

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class WatchdogReport:
    slow_steps: List[int]
    step_times: List[float]

    def straggler_fraction(self) -> float:
        return len(self.slow_steps) / max(len(self.step_times), 1)


def require_trainable(cfg: ArchConfig) -> None:
    """The kernels (``"cuda"``) have no backward; training takes the
    chunked paths, which the caller must choose."""
    for field in ("attention_impl", "ssm_impl"):
        if getattr(cfg, field) == "cuda":
            raise ValueError(
                f"{cfg.name}: {field}='cuda' cannot train (the CUDA kernels "
                f"have no backward); set {field}='chunked', the JAX "
                "package's training default")


class Trainer:
    def __init__(self, cfg: ArchConfig, *, shape: Optional[ShapeConfig] = None,
                 seq_len: int = 128, batch: int = 4,
                 opt: Optional[AdamWConfig] = None,
                 lr_fn: Optional[Callable] = None,
                 data=None, seed: int = 0,
                 instrument: bool = True,
                 interval_steps: float = 2.0,
                 microbatch: int = 1,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 keep_n: int = 3,
                 straggler_factor: float = 3.0,
                 defer_analysis: bool = True,
                 history_cap: int = 1024,
                 device: DeviceLike = None):
        require_trainable(cfg)
        self.cfg = cfg
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        self.shape = shape or ShapeConfig("adhoc_train", "train", seq_len, batch)
        self.opt_cfg = opt or AdamWConfig()
        self.lr_fn = lr_fn or constant(self.opt_cfg.lr)
        self.seed = seed
        self.instrument = instrument
        self.microbatch = microbatch
        self.straggler_factor = straggler_factor

        if data is None:
            from repro_torch.data.synthetic import SyntheticCorpus
            data = SyntheticCorpus(
                cfg.vocab_size, self.shape.seq_len, self.shape.global_batch,
                seed=seed,
                n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                d_model=cfg.d_model, n_patches=cfg.n_patches)
        self.data = data

        self.table: Optional[BlockTable] = (
            build_block_table(self.model, self.shape) if instrument else None)
        self.interval_uow = (interval_steps * self.table.step_uow()
                             if self.table else 0.0)
        # defer_analysis=True (the default) only logs steps during training
        # (near-zero host-side cost per step) and batch-analyzes at
        # profile() through the vectorized path; False = legacy per-step
        # replay inside the training loop
        self.builder = (IntervalBuilder(self.table, self.interval_uow,
                                        defer=defer_analysis)
                        if self.table else None)

        self._step_fn = make_train_step(self.model, self.opt_cfg, self.lr_fn,
                                        table=self.table,
                                        microbatch=microbatch,
                                        instrument=instrument)
        self._uninstrumented = make_train_step(
            self.model, self.opt_cfg, self.lr_fn, table=None,
            microbatch=microbatch, instrument=False)

        self.ckpt = (Checkpointer(ckpt_dir, keep_n=keep_n)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.step_times: List[float] = []
        self.slow_steps: List[int] = []
        # bounded recent-step window; full-run aggregates live in the
        # repro_torch.obs MetricsRegistry
        self.metrics_history: Deque[Dict[str, float]] = \
            deque(maxlen=max(history_cap, 1))
        self._tokens_per_step = self.shape.tokens
        # batched end-of-run readback of the device meter (one device sync
        # per run, not per interval); see read_meters in core/meter.py
        self.meter_reading: Optional[Dict[str, np.ndarray]] = None
        # the initial parameters, drawn at the first init_state, in host
        # memory (the device holds only the states built from them)
        self._init_params = None

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh train state.  The first call draws the parameters from
        a generator seeded with ``seed`` and keeps a host copy of them; every
        later call copies that onto the device, which gives the same values
        as drawing them again."""
        if self._init_params is None:
            params = self.model.init(torch.Generator().manual_seed(self.seed))
            self._init_params = tree_map(
                lambda t: t.detach().to("cpu", copy=True), params)
        else:
            params = tree_map(lambda t: t.to(self.device, copy=True),
                                 self._init_params)
        rng = np.asarray([0, self.seed & 0xFFFFFFFF], np.uint32)
        return init_train_state(self.model, params, self.opt_cfg, self.table,
                                rng=rng)

    def _device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = self.data.batch_at(step)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in b.items() if k != "domains"}

    def run(self, n_steps: int, *, state: Optional[TrainState] = None,
            resume: bool = True, log_every: int = 0) -> TrainState:
        if state is None:
            state = self.init_state()
            if resume and self.ckpt is not None:
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, extra = self.ckpt.restore(state)
                    log.info("resumed from step %s", latest)
        start = int(state.step)
        with obs.span("train.run", start=start, steps=n_steps):
            for s in range(start, n_steps):
                batch = self._device_batch(s)
                t0 = time.perf_counter()
                state, metrics, aux = self._step_fn(state, batch)
                sync_device(metrics["loss"])
                dt = time.perf_counter() - t0
                self._post_step(s, dt, metrics, aux)
                if (self.ckpt is not None and self.ckpt_every
                        and (s + 1) % self.ckpt_every == 0):
                    self.ckpt.save(s + 1, state)
                if log_every and (s + 1) % log_every == 0:
                    log.info("step %d loss %.4f (%.0f ms)", s + 1,
                             float(metrics["loss"]), dt * 1e3)
            if self.ckpt is not None:
                self.ckpt.wait()
            self._drain_device(state)
        return state

    def _drain_device(self, state: TrainState) -> None:
        """End-of-run device drain: one batched meter readback plus one
        chunked fetch of any device-resident dynamic step-log entries —
        the hot loop itself never blocks on a device->host transfer."""
        if state.meter is not None:
            self.meter_reading = read_meter(state.meter)
        if self.builder is not None:
            materialize_dyn(self.builder.step_log)

    def _post_step(self, step: int, dt: float, metrics, aux) -> None:
        self.step_times.append(dt)
        med = float(np.median(self.step_times[-50:]))
        if len(self.step_times) > 5 and dt > self.straggler_factor * med:
            self.slow_steps.append(step)
            obs.metrics().count("train.stragglers")
            log.warning("straggler: step %d took %.0f ms (median %.0f ms)",
                        step, dt * 1e3, med * 1e3)
        row = {k: float(v) for k, v in metrics.items()}
        self.metrics_history.append(row)
        m = obs.metrics()
        m.count("train.steps")
        m.observe("train.step_s", dt)
        m.record("train.loss", row.get("loss", 0.0))
        m.record("train.tokens_per_s", self._tokens_per_step / max(dt, 1e-9))
        if self.builder is not None:
            dyn = {}
            deferred = self.builder.deferred
            for k in ("expert_tokens", "dropped_tokens"):
                if k in aux:
                    # deferred builders log the device tensor as-is — no
                    # per-step host sync; _drain_device fetches them in
                    # chunked batches after the run (materialize_dyn)
                    dyn[k] = aux[k] if deferred else aux[k].cpu().numpy()
            self.builder.add_step(dyn or None)

    # ------------------------------------------------------------------
    def profile(self, *, max_workers: Optional[int] = None,
                chunk_steps: Optional[int] = None) -> Profile:
        """Finalize the profile.  ``max_workers > 1`` shards the deferred
        step stream into chunks analyzed on a thread pool and merged in
        stream order — bit-for-bit identical to the serial finalize."""
        if self.builder is None:
            raise RuntimeError("instrumentation disabled")
        materialize_dyn(self.builder.step_log)
        with obs.span("train.profile_finalize",
                      workers=int(max_workers or 0)):
            if max_workers is not None and max_workers > 1:
                return self.builder.finalize_parallel(
                    chunk_steps=chunk_steps, max_workers=max_workers)
            return self.builder.finalize()

    def watchdog_report(self) -> WatchdogReport:
        return WatchdogReport(self.slow_steps, self.step_times)

    # ------------------------------------------------------------------
    def make_runner(self, *, instrument: bool = False) -> SimpleRunner:
        """StepRunner for replay: reset() builds a fresh state (or restores
        one) at a step; run_step() executes one deterministic step
        (stateless data)."""
        step_fn = self._step_fn if instrument else self._uninstrumented

        def reset(step: int) -> TrainState:
            state = self.init_state()
            if step > 0 and self.ckpt is not None:
                steps = [s for s in self.ckpt.all_steps() if s <= step]
                if steps:
                    state, _ = self.ckpt.restore(state, steps[-1])
            return state

        def run(state: TrainState, step: int) -> TrainState:
            # fast-forward gap (checkpoint granularity) executes real steps
            state, _, _ = step_fn(state, self._device_batch(step))
            return state

        return SimpleRunner(reset, run)
