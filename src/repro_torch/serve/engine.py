# Counterpart of src/repro/serve/engine.py; nothing of it is left unported.
# One single-row prefill cache is reused for every prefill, where the
# reference makes a new one each time, and so are the zero enc-dec frames and
# VLM patches that `_insert` passes (the reference makes new zeros each time).
"""Serving engine: continuous batching over a fixed-shape decode batch.

Requests prefill into a single-row cache (fixed prefill length, padded) and
are inserted into a free decode slot; every engine iteration decodes the full
batch (inactive slots masked).  The engine is a *profiled program*: prefill
and decode iterations emit different hook streams (merged BlockTable), so
serving intervals genuinely vary in composition — the serving analogue of the
paper's multi-phase workloads.  ``snapshot()``/``restore()`` capture engine
state for replay resets and elastic migration.

Device state (the cache, the last tokens) is updated in place; the host reads
the device once per decode step (the new tokens) and keeps a mirror of the
rows' lengths, so the loop has no other synchronisation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.blocks_lm import build_block_table
from repro_torch.core.intervals import IntervalBuilder, Profile
from repro_torch.core.registry import BlockTable, merge_tables
from repro_torch.device import DeviceLike
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.serve.sampler import greedy, sample


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # [P] int32
    max_new_tokens: int
    submitted_at: float = 0.0
    output: Optional[List[int]] = None
    finished_at: float = 0.0


class SyntheticRequests:
    """Deterministic request stream (stateless in arrival index)."""

    def __init__(self, vocab: int, *, prompt_len: int = 32,
                 mean_new: int = 24, seed: int = 0):
        self.vocab, self.prompt_len, self.mean_new, self.seed = \
            vocab, prompt_len, mean_new, seed

    def request(self, i: int) -> Request:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        p = rng.integers(0, self.vocab, size=self.prompt_len).astype(np.int32)
        n = int(rng.integers(self.mean_new // 2, self.mean_new * 2))
        return Request(i, p, n)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, *, batch: int = 4, max_seq: int = 128,
                 prefill_len: int = 32, seed: int = 0,
                 temperature: float = 0.0, instrument: bool = True,
                 interval_steps: float = 4.0,
                 defer_analysis: bool = True,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.model: Model = build_model(cfg, device=device)
        self.device = self.model.device
        self.batch, self.max_seq, self.prefill_len = batch, max_seq, prefill_len
        self.temperature = temperature
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

        self.table: Optional[BlockTable] = None
        self.builder: Optional[IntervalBuilder] = None
        if instrument:
            # FLOP-weighted unit of work: serving steps are heterogeneous in
            # tensor volume (prefill vs decode), see build_block_table docs
            tp = build_block_table(
                self.model, ShapeConfig("p", "prefill", prefill_len, 1),
                train=False, unit="flops")
            td = build_block_table(
                self.model, ShapeConfig("d", "decode", max_seq, batch),
                train=False, unit="flops")
            self.table = merge_tables({"prefill": tp, "decode": td})
            iu = interval_steps * self.table.step_uow("decode")
            # defer_analysis=True (the default) only logs (kind, dyn) per
            # step and runs the vectorized batch analysis once at
            # profile(); False = legacy per-step replay
            self.builder = IntervalBuilder(self.table, iu,
                                           defer=defer_analysis)

        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        self.cache = self.model.init_cache(self.batch, self.max_seq)
        # one single-row cache for every prefill; a prefill only writes its
        # first `prefill_len` positions and overwrites the whole SSM and conv
        # state and cross cache, so the rest stays as in a fresh cache
        self.pre_cache = self.model.init_cache(1, self.max_seq)
        # the prefill's stub inputs: zero frames (enc-dec) and patches (VLM)
        # [1, n, d_model] f32, as the reference's, made once
        self.stub_inputs = {}
        if self.cfg.family == "encdec":
            self.stub_inputs["frames"] = torch.zeros(
                (1, self.cfg.n_frames, self.cfg.d_model), device=self.device)
        if self.cfg.n_patches:
            self.stub_inputs["patches"] = torch.zeros(
                (1, self.cfg.n_patches, self.cfg.d_model), device=self.device)
        self.lengths = np.zeros(self.batch, np.int64)   # host mirror
        self.active = np.zeros(self.batch, bool)
        self.remaining = np.zeros(self.batch, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.batch
        self.last_token = torch.zeros((self.batch, 1), dtype=torch.int32,
                                      device=self.device)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.iterations = 0
        self.kinds_log: List[str] = []

    def submit(self, req: Request):
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _insert(self, slot: int, req: Request):
        # prompts are padded with token 0 to prefill_len and not masked
        p = np.zeros(self.prefill_len, np.int32)
        n = min(len(req.prompt), self.prefill_len)
        p[:n] = req.prompt[:n]
        batch = {"tokens": torch.from_numpy(p)[None].to(self.device),
                 **self.stub_inputs}
        logits, pre_cache, _ = self.model.prefill(self.model_params, batch,
                                                  self.pre_cache)
        # copy row 0 of every key of the single-row cache into the decode
        # slot (cross cache and int8 scales included), in place and on the
        # device
        for key, dst in self.cache.items():
            if key == "length":
                dst[slot].copy_(pre_cache[key][0])
            else:
                dst[:, slot].copy_(pre_cache[key][:, 0])
        self.lengths[slot] = self.prefill_len
        tok = greedy(logits)
        self.last_token[slot] = tok[0]
        self.active[slot] = True
        self.remaining[slot] = req.max_new_tokens
        req.output = [int(tok[0, 0])]
        self.slot_req[slot] = req
        if self.builder is not None:
            self.builder.add_step(kind="prefill")
        self.kinds_log.append("prefill")
        self.iterations += 1
        obs.metrics().count("serve.prefill_iters")

    def _decode_all(self):
        logits, self.cache, _ = self.model.decode_step(
            self.model_params, self.last_token, self.cache)
        if self.temperature > 0:
            tok = sample(logits, self.rng, temperature=self.temperature)
        else:
            tok = greedy(logits)
        self.last_token = tok
        self.lengths += 1              # the step adds 1 to every row's length
        toks = tok[:, 0].cpu().numpy()  # the step's one device read
        for b in range(self.batch):
            if not self.active[b]:
                continue
            req = self.slot_req[b]
            req.output.append(int(toks[b]))
            self.remaining[b] -= 1
            if (self.remaining[b] <= 0
                    or self.lengths[b] >= self.max_seq - 1):
                req.finished_at = time.perf_counter()
                self.done.append(req)
                self.active[b] = False
                self.slot_req[b] = None
        if self.builder is not None:
            self.builder.add_step(kind="decode")
        self.kinds_log.append("decode")
        self.iterations += 1
        obs.metrics().count("serve.decode_iters")

    # ------------------------------------------------------------------
    def step(self, params) -> bool:
        """One engine iteration.  Returns False when idle."""
        self.model_params = params
        free = [b for b in range(self.batch) if not self.active[b]]
        if free and self.queue:
            self._insert(free[0], self.queue.pop(0))
            return True
        if self.active.any():
            self._decode_all()
            return True
        return False

    def run(self, params, requests: List[Request]) -> Dict[str, float]:
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        with obs.span("serve.run", requests=len(requests)):
            while self.step(params):
                pass
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        toks = sum(len(r.output or []) for r in self.done)
        lat = [r.finished_at - r.submitted_at for r in self.done
               if r.finished_at]
        m = obs.metrics()
        m.count("serve.requests", len(self.done))
        m.count("serve.tokens", toks)
        m.record("serve.tokens_per_s", toks / max(wall, 1e-9))
        for v in lat:
            m.observe("serve.latency_s", v)
        return {
            "wall_s": wall,
            "tokens": toks,
            "tokens_per_s": toks / max(wall, 1e-9),
            "requests": len(self.done),
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "iterations": self.iterations,
        }

    # ------------------------------------------------------------------
    def profile(self) -> Profile:
        assert self.builder is not None
        with obs.span("serve.profile_finalize"):
            return self.builder.finalize()

    def snapshot(self) -> Dict[str, Any]:
        """Host-memory engine state (elastic migration / replay resets).
        Cache leaves are numpy arrays; a bf16 cache is kept as float32,
        which holds every bf16 value exactly."""
        def to_np(t: torch.Tensor) -> np.ndarray:
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
        return {
            "cache": {k: to_np(v) for k, v in self.cache.items()},
            "active": self.active.copy(),
            "remaining": self.remaining.copy(),
            "last_token": to_np(self.last_token),
            "iterations": self.iterations,
        }

    def restore(self, snap: Dict[str, Any]):
        for k, v in snap["cache"].items():           # in place
            self.cache[k].copy_(torch.from_numpy(np.asarray(v)))
        self.lengths = snap["cache"]["length"].astype(np.int64)
        self.active = snap["active"].copy()
        self.remaining = snap["remaining"].copy()
        self.last_token = torch.from_numpy(
            np.asarray(snap["last_token"])).to(self.device)
        self.iterations = snap["iterations"]
