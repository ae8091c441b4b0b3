# Counterpart of src/repro/serve/engine.py; nothing of it is left unported.
# One single-row prefill cache is reused for every prefill, where the
# reference makes a new one each time, and so are the zero enc-dec frames and
# VLM patches that `_insert` passes (the reference makes new zeros each time).
# The engine's phases are `obs` spans (`engine.prefill`, `engine.decode` and
# their `.forward`, `.read`, `.rows`; `profile.add_step`), and the forward
# phases' durations go into the registry's histograms of the same names;
# `run` writes nothing into the registry (the reference's `serve.*` values
# had no reader).  On the card a greedy decode step is captured once into a
# CUDA graph and replayed (`graph_captures`); the reference has no such step.
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

The decode step has fixed shapes and only in-place device state, so on the
card it is issued from the host once: the first greedy step after a new cache
or new parameters runs eagerly (the warm-up), the next one is captured into a
``torch.cuda.CUDAGraph`` over the cache, ``last_token`` and the parameters,
and every later one replays that graph (`graph_captures` says where: a CUDA
device, greedy sampling, plain tensors).  The graph replays the very function
the eager step calls.  ``reset()`` makes a new cache and so drops the
graph; ``restore()`` writes the cache and ``last_token`` in place and keeps
it.  What the captured step counted into the registry's counters (the MoE
counts, the kernel wrappers' launches) is counted again at each replay
(`obs.CountRecord`); ``serve.decode_graph_captures`` and
``serve.decode_graph_replays`` count the captures and the replays.

Each iteration is a span of the process's tracer (`repro_torch.obs`): a
prefill ``engine.prefill`` (``req``, ``slot``), a decode step
``engine.decode`` (``rows``: the rows it decoded), each split into
``.forward`` (all the iteration issues to the device before its read: a
decode step's graph replay where it has one),
``.read`` (the read, which waits for the device) and, for a decode step,
``.rows`` (the host's walk over the rows); ``profile.add_step`` is the
profile's hook.  ``engine.prefill.forward`` and ``engine.decode.forward``
also observe their seconds into the registry's histograms of those names,
one observation an iteration, tracing on or off.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.blocks_lm import build_block_table
from repro_torch.core.intervals import IntervalBuilder, Profile
from repro_torch.core.registry import BlockTable, merge_tables
from repro_torch.device import DeviceLike
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.serve.sampler import greedy, sample


def graph_captures(device: torch.device, temperature: float, params,
                   cache) -> bool:
    """Whether the engine captures its decode step into a CUDA graph: on a
    CUDA device, greedy, outside any trace or fake-tensor mode, and with
    every tensor of the parameters and the cache a plain one (not a DTensor,
    not a fake tensor).  Elsewhere the step runs eagerly."""
    if device.type != "cuda" or temperature > 0 or obs.tracing():
        return False
    leaves = tree_leaves(params) + tree_leaves(cache)
    return all(type(t) in (torch.Tensor, torch.nn.Parameter)
               for t in leaves if isinstance(t, torch.Tensor))


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
        self._drop_graph()      # a graph holds the old cache's addresses

    def _drop_graph(self):
        """Forget the decode step's graph: the next decode step decides
        anew (`graph_captures`), warms up eagerly, and the one after it
        captures."""
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_counts: Optional[obs.CountRecord] = None
        self._graph_params = None       # the parameters it was decided for
        self._graph_on = False
        self._warmed = False

    def submit(self, req: Request):
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _insert(self, slot: int, req: Request):
        with obs.span("engine.prefill", req=req.req_id, slot=slot):
            # prompts are padded with token 0 to prefill_len and not masked
            p = np.zeros(self.prefill_len, np.int32)
            n = min(len(req.prompt), self.prefill_len)
            p[:n] = req.prompt[:n]
            with obs.timed("engine.prefill.forward"):
                batch = {"tokens": torch.from_numpy(p)[None].to(self.device),
                         **self.stub_inputs}
                logits, pre_cache, _ = self.model.prefill(
                    self.model_params, batch, self.pre_cache)
                # copy row 0 of every key of the single-row cache into the
                # decode slot (cross cache and int8 scales included), in
                # place and on the device
                for key, dst in self.cache.items():
                    if key == "length":
                        dst[slot].copy_(pre_cache[key][0])
                    else:
                        dst[:, slot].copy_(pre_cache[key][:, 0])
                tok = greedy(logits)
                self.last_token[slot] = tok[0]
            with obs.span("engine.prefill.read"):
                first = int(tok[0, 0])         # waits for the prefill
            self.lengths[slot] = self.prefill_len
            self.active[slot] = True
            self.remaining[slot] = req.max_new_tokens
            req.output = [first]
            self.slot_req[slot] = req
            if self.builder is not None:
                with obs.span("profile.add_step"):
                    self.builder.add_step(kind="prefill")
            self.kinds_log.append("prefill")
            self.iterations += 1
            obs.metrics().count("serve.prefill_iters")

    def _decode_tokens(self, params):
        """The decode step on the device: the model's step and the sampler,
        the new tokens written into ``last_token`` in place.  The eager step
        and the graph both run this."""
        logits, _, _ = self.model.decode_step(params, self.last_token,
                                              self.cache)
        if self.temperature > 0:
            tok = sample(logits, self.rng, temperature=self.temperature)
        else:
            tok = greedy(logits)
        self.last_token.copy_(tok)

    def _issue_decode(self):
        """Issue one decode step: replay its graph, capture it, or run it
        eagerly (the warm-up, and wherever `graph_captures` is false)."""
        params = self.model_params
        if params is not self._graph_params:     # new parameters: decide anew
            self._drop_graph()
            self._graph_params = params
            self._graph_on = graph_captures(self.device, self.temperature,
                                            params, self.cache)
        if self._graph is not None:
            self._graph.replay()
            self._graph_counts.replay()
            obs.metrics().count("serve.decode_graph_replays")
        elif self._graph_on and self._warmed:
            graph = torch.cuda.CUDAGraph()
            with obs.CountRecord() as counts:
                with torch.cuda.graph(graph):
                    self._decode_tokens(params)
            graph.replay()                       # the capture ran nothing
            self._graph, self._graph_counts = graph, counts
            obs.metrics().count("serve.decode_graph_captures")
        else:
            self._decode_tokens(params)
            self._warmed = True

    def _decode_all(self):
        with obs.span("engine.decode") as sp:
            with obs.timed("engine.decode.forward"):
                self._issue_decode()
            self.lengths += 1          # the step adds 1 to every row's length
            with obs.span("engine.decode.read"):
                # the step's one device read
                toks = self.last_token[:, 0].cpu().numpy()
            rows = 0
            with obs.span("engine.decode.rows"):
                for b in range(self.batch):
                    if not self.active[b]:
                        continue
                    rows += 1
                    req = self.slot_req[b]
                    req.output.append(int(toks[b]))
                    self.remaining[b] -= 1
                    if (self.remaining[b] <= 0
                            or self.lengths[b] >= self.max_seq - 1):
                        req.finished_at = time.perf_counter()
                        self.done.append(req)
                        self.active[b] = False
                        self.slot_req[b] = None
            sp.set(rows=rows)
            if self.builder is not None:
                with obs.span("profile.add_step"):
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
        # in place: a captured decode graph holds these buffers
        for k, v in snap["cache"].items():
            self.cache[k].copy_(torch.from_numpy(np.asarray(v)))
        self.lengths = snap["cache"]["length"].astype(np.int64)
        self.active = snap["active"].copy()
        self.remaining = snap["remaining"].copy()
        self.last_token.copy_(torch.from_numpy(np.asarray(snap["last_token"])))
        self.iterations = snap["iterations"]
