# Counterpart of src/repro/core/intervals.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Interval discovery + signatures (paper §III-C2), host side.

The IntervalBuilder replays each step's hook stream (block ids + per-hook
count-stamps, precomputed from the BlockTable) against the global unit-of-work
counter, closing an interval whenever the counter crosses a multiple of the
interval size — exactly the paper's hook logic.  Each interval gets:

- a **BBV** (block-frequency vector incl. virtual/dynamic entries),
- a **count-stamp vector** (global counter at the last execution of each
  block within the interval),
- the cumulative hit count of every block at its last execution (used to
  derive markers = (block, required-hit-count) pairs).

Three build paths produce bit-for-bit identical Profiles:

- ``add_step``  — legacy per-step replay (reference implementation),
- ``add_steps`` — vectorized batch path (one cumsum/searchsorted/bincount
  pass over the concatenated hook stream; see ``intervals_vec``),
- ``build_profile_parallel`` — chunked ``concurrent.futures`` analysis whose
  per-chunk partial states merge associatively.

``IntervalBuilder(..., defer=True)`` only *logs* steps as they stream in
(near-zero per-step cost inside a training/serving loop) and runs the batch
analysis once at ``finalize()``.  ``step_log`` always records the full
``(kind, dyn)`` stream — it is the content-addressed cache key input for
``profile_store.cached_build`` / ``cached_finalize``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.intervals_vec import (ChunkResult, Step, analyze_steps,
                                      analyze_steps_parallel, as_steps)
from repro_torch.core.registry import BlockTable


@dataclasses.dataclass(frozen=True, slots=True)
class Marker:
    block: int          # block id
    hits: int           # cumulative executions of ``block`` since run start
    uow: float          # counter value at the marked hook (for pro-rating)

    def to_json(self):
        return {"block": int(self.block), "hits": int(self.hits),
                "uow": float(self.uow)}

    @staticmethod
    def from_json(d):
        return Marker(d["block"], d["hits"], d["uow"])


@dataclasses.dataclass(slots=True)
class Interval:
    idx: int
    start_uow: float
    end_uow: float
    end_marker: Marker
    bbv: np.ndarray              # [n_blocks] executions within interval
    stamps: np.ndarray           # [n_blocks] uow at last exec (-1 = never)
    hits_at_stamp: np.ndarray    # [n_blocks] cumulative hits at last exec
    start_step: float            # fractional step position of interval start
    end_step: float


@dataclasses.dataclass
class Profile:
    table: BlockTable
    interval_uow: float
    intervals: List[Interval]
    total_uow: float
    n_steps: int
    step_uow: float
    dyn_history: Dict[str, np.ndarray]   # per-step dynamic values

    @property
    def n_intervals(self) -> int:
        return len(self.intervals)

    def bbv_matrix(self) -> np.ndarray:
        return np.stack([iv.bbv for iv in self.intervals]) \
            if self.intervals else np.zeros((0, self.table.n_blocks))

    def start_marker(self, idx: int) -> Optional[Marker]:
        """Start marker of interval ``idx`` = end marker of ``idx-1``."""
        if idx == 0:
            return None
        return self.intervals[idx - 1].end_marker


class IntervalBuilder:
    def __init__(self, table: BlockTable, interval_uow: float,
                 defer: bool = False):
        assert interval_uow > 0
        self.table = table
        self.interval_uow = float(interval_uow)
        self.ids, self.cum = table.expand()         # "default" stream
        self.step_total = float(self.cum[-1])       # default-kind step UoW
        self._cur_total = self.step_total
        self.n = table.n_blocks
        self._g = 0.0                               # global counter
        self._cum_hits = np.zeros(self.n, np.int64)
        self._bbv = np.zeros(self.n, np.float64)
        self._stamps = np.full(self.n, -1.0)
        self._hits_at = np.zeros(self.n, np.int64)
        self._ivl_start = 0.0
        self._ivl_start_step = 0.0
        self._step = 0
        self.intervals: List[Interval] = []
        self._dyn: Dict[str, List] = {}
        self._virtual = [(i, b) for i, b in enumerate(table.blocks)
                         if b.virtual]
        # per-builder hook-stream memo: one expansion per kind per builder
        self._streams: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
            "default": (self.ids, self.cum)}
        self.step_log: List[Step] = []   # full (kind, dyn) stream, in order
        self._defer = defer              # True: analyze lazily at finalize()
        self._processed = 0              # prefix of step_log already analyzed

    def _stream(self, kind: str) -> Tuple[np.ndarray, np.ndarray]:
        try:
            return self._streams[kind]
        except KeyError:
            return self._streams.setdefault(kind, self.table.expand(kind))

    @property
    def deferred(self) -> bool:
        """True when steps are only logged and analyzed at ``finalize``."""
        return self._defer

    # ------------------------------------------------------------------
    def add_step(self, dyn: Optional[Dict[str, Any]] = None,
                 kind: str = "default"):
        """Legacy per-step replay (the reference implementation)."""
        self.step_log.append((kind, dyn))
        if self._defer:
            return
        self._add_step_eager(dyn, kind)
        self._processed += 1

    def _add_step_eager(self, dyn: Optional[Dict[str, Any]],
                        kind: str) -> None:
        ids, cum = self._stream(kind)
        self._cur_total = float(cum[-1]) if len(cum) else 0.0
        g0 = self._g
        # record dynamic history
        if dyn:
            for k, v in dyn.items():
                self._dyn.setdefault(k, []).append(np.asarray(v))

        # boundary crossings within this step (counter hits multiples of I)
        I = self.interval_uow
        next_bound = (np.floor(g0 / I) + 1) * I
        abs_cum = g0 + cum
        start = 0
        while next_bound <= abs_cum[-1] + 1e-9:
            j = int(np.searchsorted(abs_cum, next_bound - 1e-9, side="left"))
            j = min(j, len(ids) - 1)
            self._consume(ids, cum, start, j + 1, g0)
            self._close(abs_cum[j], ids[j],
                        step_frac=self._step + (j + 1) / len(ids), dyn=dyn)
            start = j + 1
            # one hook may span several boundaries: the next boundary is the
            # first multiple of I strictly beyond the closing hook (no
            # zero-width intervals — paper hook semantics)
            next_bound = (np.floor(abs_cum[j] / I + 1e-12) + 1) * I
        if start < len(ids):
            self._consume(ids, cum, start, len(ids), g0)
        self._g = abs_cum[-1]
        self._step += 1

    def _consume(self, all_ids, all_cum, lo: int, hi: int, g0: float):
        ids, cum = all_ids[lo:hi], all_cum[lo:hi]
        if len(ids) == 0:
            return
        np.add.at(self._bbv, ids, 1.0)
        np.add.at(self._cum_hits, ids, 1)
        # last-write-wins fancy assignment = last execution per block
        self._stamps[ids] = g0 + cum
        self._hits_at[ids] = self._cum_hits[ids]

    def _close(self, end_uow: float, end_block: int, step_frac: float,
               dyn: Optional[Dict[str, Any]]):
        bbv = self._bbv.copy()
        # virtual signature entries: pro-rate this step's dynamic values by
        # the uow fraction the interval took of the step
        if dyn:
            cur = self._cur_total    # self._g is still the step-start UoW here
            frac = min(1.0, (end_uow - max(self._ivl_start, self._g))
                       / cur) if cur else 0.0
            for i, b in self._virtual:
                if b.dyn_key in dyn:
                    v = np.asarray(dyn[b.dyn_key], np.float64)
                    val = v[b.dyn_index] if (b.dyn_index >= 0 and v.ndim) else v
                    bbv[i] += float(val) * max(frac, 0.0)
        marker = Marker(int(end_block), int(self._cum_hits[end_block]),
                        float(end_uow))
        self.intervals.append(Interval(
            idx=len(self.intervals),
            start_uow=self._ivl_start,
            end_uow=float(end_uow),
            end_marker=marker,
            bbv=bbv,
            stamps=self._stamps.copy(),
            hits_at_stamp=self._hits_at.copy(),
            start_step=self._ivl_start_step,
            end_step=step_frac,
        ))
        self._bbv[:] = 0.0
        self._stamps[:] = -1.0
        self._hits_at[:] = 0
        self._ivl_start = float(end_uow)
        self._ivl_start_step = step_frac

    # ------------------------------------------------------------------
    # batch (vectorized) path
    # ------------------------------------------------------------------
    def add_steps(self, steps: Optional[Sequence[Step]] = None, *,
                  n_steps: Optional[int] = None,
                  dyn_per_step: Optional[Sequence[Optional[Dict]]] = None,
                  kinds: Optional[Sequence[str]] = None) -> None:
        """Vectorized batch path: analyze a run of steps in one pass.

        Accepts either an explicit ``[(kind, dyn), ...]`` stream or the
        ``n_steps``/``dyn_per_step``/``kinds`` spelling.  Produces exactly
        the intervals the equivalent sequence of ``add_step`` calls would.
        """
        steps = as_steps(n_steps=n_steps, dyn_per_step=dyn_per_step,
                         kinds=kinds, steps=steps)
        self.step_log.extend(steps)
        if self._defer:
            return
        self._process_batch(steps)
        self._processed += len(steps)

    def _process_batch(self, steps: Sequence[Step]) -> None:
        if not steps:
            return
        res = analyze_steps(self.table, self.interval_uow, steps,
                            g0=self._g, step0=self._step,
                            baseline_hits=self._cum_hits,
                            expand=self._stream)
        self._absorb(res, steps)

    def absorb(self, res: ChunkResult, steps: Sequence[Step]) -> None:
        """Merge an externally-computed chunk (see ``analyze_steps_parallel``)
        into the builder.  Chunks must arrive in stream order."""
        self.step_log.extend(steps)
        self._processed += len(steps)
        self._absorb(res, steps)

    def _absorb(self, res: ChunkResult, steps: Sequence[Step]) -> None:
        # Associative merge of a chunk's partial state: the carried open
        # interval flows into the chunk's first close (counts add; the
        # chunk's stamps/hits win for blocks it touched), the chunk's
        # trailing open state becomes the new carry.  Virtual-block (dyn)
        # contributions are applied after count merging so float addition
        # order matches the legacy path bit-for-bit.
        n_cl = len(res.end_uow)
        dyn_by_row: Dict[int, List[Tuple[int, float]]] = {}
        for r, i, v in res.dyn_add:
            dyn_by_row.setdefault(r, []).append((i, v))
        # plain-python scalars up front: the append loop below runs once per
        # closed interval and dominates batch-path absorb time
        eu = res.end_uow.tolist()
        es = res.end_step.tolist()
        mb = res.marker_block.tolist()
        mh = res.marker_hits.tolist()
        counts, stamps, hits = res.counts, res.stamps, res.hits
        ivls = self.intervals
        prev_eu, prev_es = self._ivl_start, self._ivl_start_step
        for r in range(n_cl):
            if r == 0:
                touched = counts[0] > 0
                bbv = counts[0] + self._bbv
                stp = np.where(touched, stamps[0], self._stamps)
                hit = np.where(touched, hits[0], self._hits_at)
            else:
                bbv, stp, hit = counts[r], stamps[r], hits[r]
            if dyn_by_row:
                for i, v in dyn_by_row.get(r, ()):
                    bbv[i] += v
            ivls.append(Interval(
                idx=len(ivls), start_uow=prev_eu, end_uow=eu[r],
                end_marker=Marker(mb[r], mh[r], eu[r]), bbv=bbv,
                stamps=stp, hits_at_stamp=hit, start_step=prev_es,
                end_step=es[r]))
            prev_eu, prev_es = eu[r], es[r]
        if n_cl:
            self._bbv = res.counts[n_cl].copy()
            self._stamps = res.stamps[n_cl].copy()
            self._hits_at = res.hits[n_cl].copy()
            self._ivl_start = float(res.end_uow[-1])
            self._ivl_start_step = float(res.end_step[-1])
        else:
            tail = res.counts[0]
            touched = tail > 0
            self._bbv = self._bbv + tail
            self._stamps = np.where(touched, res.stamps[0], self._stamps)
            self._hits_at = np.where(touched, res.hits[0], self._hits_at)
        self._g = res.g_end
        self._cum_hits = res.hits_end.copy()
        self._step += res.n_steps
        for _, dyn in steps:
            if dyn:
                for k, v in dyn.items():
                    self._dyn.setdefault(k, []).append(np.asarray(v))

    # ------------------------------------------------------------------
    def finalize_parallel(self, *, chunk_steps: Optional[int] = None,
                          max_workers: Optional[int] = None) -> Profile:
        """Sharded ``finalize``: the pending (deferred) step log is split
        into whole-step chunks, analyzed concurrently on a thread pool and
        merged in stream order — bit-for-bit identical to ``finalize()``.
        The chunk starts are positioned at the builder's current state
        (global counter, step index, cumulative hits), so the path also
        works after eager/absorbed prefixes.
        """
        pending = self.step_log[self._processed:]
        if pending:
            results = analyze_steps_parallel(
                self.table, self.interval_uow, pending,
                chunk_steps=chunk_steps, max_workers=max_workers,
                g0=self._g, step0=self._step, baseline_hits=self._cum_hits)
            self._processed = len(self.step_log)
            for res, chunk in results:
                self._absorb(res, chunk)
        return self.finalize()

    def finalize(self) -> Profile:
        if self._processed < len(self.step_log):   # deferred analysis
            pending = self.step_log[self._processed:]
            self._processed = len(self.step_log)
            self._process_batch(pending)
        dyn_hist = {k: np.stack(v) for k, v in self._dyn.items()}
        return Profile(
            table=self.table,
            interval_uow=self.interval_uow,
            intervals=self.intervals,
            total_uow=self._g,
            n_steps=self._step,
            step_uow=self.step_total,
            dyn_history=dyn_hist,
        )


def build_profile_from_steps(table: BlockTable, n_steps: int,
                             interval_uow: float,
                             dyn_per_step: Optional[List[Dict]] = None,
                             *, kinds: Optional[Sequence[str]] = None,
                             method: str = "batch",
                             chunk_steps: Optional[int] = None,
                             max_workers: Optional[int] = None) -> Profile:
    """Build a Profile from a step stream.

    ``method`` selects the build path — ``"batch"`` (vectorized, default),
    ``"legacy"`` (per-step reference) or ``"parallel"`` (chunked thread
    pool); all three produce bit-for-bit identical Profiles.
    """
    steps = as_steps(n_steps=n_steps, dyn_per_step=dyn_per_step, kinds=kinds)
    return build_profile(table, interval_uow, steps, method=method,
                         chunk_steps=chunk_steps, max_workers=max_workers)


def build_profile(table: BlockTable, interval_uow: float,
                  steps: Sequence[Step], *, method: str = "batch",
                  chunk_steps: Optional[int] = None,
                  max_workers: Optional[int] = None) -> Profile:
    """Like :func:`build_profile_from_steps` but takes an explicit
    ``[(kind, dyn), ...]`` stream (serving-style heterogeneous steps)."""
    b = IntervalBuilder(table, interval_uow)
    if method == "legacy":
        for kind, dyn in steps:
            b.add_step(dyn, kind=kind)
    elif method == "batch":
        b.add_steps(steps)
    elif method == "parallel":
        for res, chunk in analyze_steps_parallel(
                table, interval_uow, steps, chunk_steps=chunk_steps,
                max_workers=max_workers):
            b.absorb(res, chunk)
    else:
        raise ValueError(f"unknown build method {method!r}")
    return b.finalize()


def build_profile_parallel(table: BlockTable, interval_uow: float,
                           steps: Sequence[Step], *,
                           chunk_steps: Optional[int] = None,
                           max_workers: Optional[int] = None) -> Profile:
    """Chunked parallel build (``concurrent.futures`` thread pool)."""
    return build_profile(table, interval_uow, steps, method="parallel",
                         chunk_steps=chunk_steps, max_workers=max_workers)
