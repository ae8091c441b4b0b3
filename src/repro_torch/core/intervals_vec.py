# Counterpart of src/repro/core/intervals_vec.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Vectorized + parallel interval analysis — the batch path of the profiler.

The legacy :class:`~repro_torch.core.intervals.IntervalBuilder` replays one step's
hook stream at a time (``np.add.at`` per step, three ``n_blocks`` copies per
closed interval).  This module computes the *same* Profile in large
vectorized passes:

1. **Offsets** — per-step unit-of-work totals are accumulated sequentially
   (``np.cumsum`` is a left-to-right running sum, so the per-step global
   counter values are bit-for-bit the floats the legacy path produces).
2. **Stream** — runs of same-kind steps broadcast the memoized per-kind
   ``(ids, cum)`` expansion into one concatenated ``(ids, abs_uow)`` stream.
3. **Closes** — every interval-boundary multiple each step can cross is
   enumerated up front and located with one batched ``searchsorted``; the
   legacy per-step skip chains (next bound = first multiple strictly past
   the closing hook) then reduce to integer jumps, so close detection is
   O(bounds · log N) vector work plus an O(closes) Python walk.  The
   boundary/epsilon formulas mirror the legacy hook logic exactly,
   including hooks that span several boundaries and multiples that close
   twice because ``m * I`` rounds past an exact step end.
4. **Signatures** — per-interval BBVs come from one segment ``bincount``
   over ``interval_idx * n_blocks + block_id``; last-execution stamps come
   from one in-order flat fancy scatter (last write wins, like the legacy
   per-step assignment); hits-at-last-execution is a closed form — the
   last execution of a block in an interval is its latest, so the hit
   count there is baseline + a row-cumsum of the counts matrix.

Chunk algebra (the parallel path): a chunk of whole steps is analyzable
knowing only its starting global counter, starting step index and baseline
per-block hit counts — all cheaply precomputable — because the legacy
builder re-derives the next interval boundary from the step-start counter at
every ``add_step``.  Each chunk therefore returns its closed intervals plus
a trailing *open state*; chunks merge associatively: the carry's open BBV
adds into the first interval of the next chunk, carry stamps/hits fill the
blocks the next chunk did not touch before its first close.  Dynamic
(virtual-block) contributions are kept separate from the execution counts
until after the merge so floating-point addition order matches the legacy
path bit-for-bit.

Equivalence with the per-step path is asserted by tests
(``tests/test_interval_batch.py``) over randomized mixed-kind streams.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading as _threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.registry import BlockTable

# one profiled step: (step kind, optional dynamic aux dict)
Step = Tuple[str, Optional[Dict[str, Any]]]


def as_steps(n_steps: Optional[int] = None,
             dyn_per_step: Optional[Sequence[Optional[Dict]]] = None,
             kinds: Optional[Sequence[str]] = None,
             steps: Optional[Sequence[Step]] = None) -> List[Step]:
    """Normalize the two step-stream spellings into ``[(kind, dyn), ...]``."""
    if steps is not None:
        return [(k, d) for k, d in steps]
    assert n_steps is not None, "need steps or n_steps"
    return [((kinds[i] if kinds is not None else "default"),
             (dyn_per_step[i] if dyn_per_step is not None else None))
            for i in range(n_steps)]


@dataclasses.dataclass
class ChunkResult:
    """Closed intervals of one run of steps, in array form.

    Row ``r`` of ``counts``/``stamps``/``hits`` describes interval ``r``; the
    last row is the trailing open-interval state.  The *start* of interval 0
    is unknown to the chunk (it lives in the carry) and is filled at merge
    time; ``dyn_add`` holds virtual-block contributions separately so they
    are applied after count merging (exact legacy addition order).
    """
    counts: np.ndarray          # [n_closes+1, n_blocks] float64 exec counts
    stamps: np.ndarray          # [n_closes+1, n_blocks] last-exec uow (-1)
    hits: np.ndarray            # [n_closes+1, n_blocks] int64 hits at stamp
    end_uow: np.ndarray         # [n_closes] float64
    end_step: np.ndarray        # [n_closes] float64 fractional step position
    marker_block: np.ndarray    # [n_closes] int64
    marker_hits: np.ndarray     # [n_closes] int64
    dyn_add: List[Tuple[int, int, float]]   # (interval row, block, value)
    g_end: float                # global counter after the chunk
    hits_end: np.ndarray        # [n_blocks] int64 cumulative hits after chunk
    n_steps: int


def _empty_result(n_blocks: int, g0: float,
                  baseline_hits: np.ndarray) -> ChunkResult:
    return ChunkResult(
        counts=np.zeros((1, n_blocks)),
        stamps=np.full((1, n_blocks), -1.0),
        hits=np.zeros((1, n_blocks), np.int64),
        end_uow=np.zeros(0), end_step=np.zeros(0),
        marker_block=np.zeros(0, np.int64), marker_hits=np.zeros(0, np.int64),
        dyn_add=[], g_end=float(g0), hits_end=baseline_hits.copy(), n_steps=0)


def analyze_steps(table: BlockTable, interval_uow: float,
                  steps: Sequence[Step], *, g0: float = 0.0, step0: int = 0,
                  baseline_hits: Optional[np.ndarray] = None,
                  expand: Optional[Callable] = None) -> ChunkResult:
    """Vectorized interval analysis of a run of steps.

    ``g0``/``step0``/``baseline_hits`` position the run inside a larger
    stream (global counter, step index and per-block cumulative hit counts
    at the start of the run).  ``expand`` overrides the per-kind stream
    lookup (the IntervalBuilder passes its per-builder memo).

    Each batch is timed into the ``intervals.*`` metrics (steps analyzed,
    intervals closed, batch seconds, intervals/s) and traced as an
    ``intervals.analyze_batch`` span when tracing is on.
    """
    t_an0 = _time.perf_counter()
    with obs.span("intervals.analyze_batch", steps=len(steps)) as _sp:
        res = _analyze_steps(table, interval_uow, steps, g0=g0, step0=step0,
                             baseline_hits=baseline_hits, expand=expand)
        n_cl = len(res.end_uow)
        _sp.set(closed=n_cl)
    dt = _time.perf_counter() - t_an0
    m = obs.metrics()
    m.count("intervals.analyzed_steps", len(steps))
    m.count("intervals.closed", n_cl)
    m.observe("intervals.analyze_s", dt)
    if n_cl:
        m.record("intervals.per_s", n_cl / max(dt, 1e-9))
    return res


def _analyze_steps(table: BlockTable, interval_uow: float,
                   steps: Sequence[Step], *, g0: float = 0.0, step0: int = 0,
                   baseline_hits: Optional[np.ndarray] = None,
                   expand: Optional[Callable] = None) -> ChunkResult:
    n = table.n_blocks
    if baseline_hits is None:
        baseline_hits = np.zeros(n, np.int64)
    if expand is None:
        expand = table.expand
    if not len(steps):
        return _empty_result(n, g0, baseline_hits)

    I = float(interval_uow)
    kinds = [k for k, _ in steps]
    streams = {k: expand(k) for k in set(kinds)}
    tot_of = {k: (float(c[-1]) if len(c) else 0.0)
              for k, (_, c) in streams.items()}
    len_of = {k: len(i) for k, (i, _) in streams.items()}

    n_steps = len(steps)
    # runs of consecutive same-kind steps (one boundary scan)
    cuts = [0] + [s for s in range(1, n_steps) if kinds[s] != kinds[s - 1]] \
        + [n_steps]
    runs: List[Tuple[int, int, str]] = [
        (cuts[r], cuts[r + 1], kinds[cuts[r]]) for r in range(len(cuts) - 1)]
    tots = np.empty(n_steps + 1)
    tots[0] = g0
    lens = np.empty(n_steps, np.int64)
    for a, b, k in runs:
        tots[a + 1:b + 1] = tot_of[k]
        lens[a:b] = len_of[k]
    # np.cumsum is a left-to-right running sum -> offs[s] is bit-for-bit the
    # legacy global counter at the start of step s
    offs = np.cumsum(tots)

    # ---- concatenated hook stream (runs of same-kind steps broadcast) ----
    hook0 = np.concatenate([[0], np.cumsum(lens)])      # [n_steps+1]
    ids_parts: List[np.ndarray] = []
    abs_parts: List[np.ndarray] = []
    base = baseline_hits.astype(np.int64, copy=True)   # hits after the chunk
    for a, b, k in runs:
        ids_k, cum_k = streams[k]
        if len(ids_k):
            ids_parts.append(np.tile(ids_k, b - a))
            abs_parts.append((offs[a:b, None] + cum_k[None, :]).ravel())
        base += (b - a) * table.step_counts(k)
    if ids_parts:
        ids = np.concatenate(ids_parts)
        absu = np.concatenate(abs_parts)
    else:
        ids = np.zeros(0, np.int64)
        absu = np.zeros(0)
    N = len(ids)

    # ---- boundary crossings (one vectorized searchsorted, all bounds) ----
    # Legacy semantics, restated per step s: process multiples of I from
    # (floor(offs[s]/I)+1)*I while <= offs[s+1]+1e-9, closing at the first
    # hook >= bound-1e-9 (clamped into the step) and skipping to the first
    # multiple strictly beyond the closing hook.  The skip chain resets at
    # every step boundary (first_bound is re-derived from the step-start
    # counter), so a multiple can legitimately close twice when I*m rounds
    # above the exact step end.  We enumerate each step's candidate
    # multiples, locate all of them with a single batched searchsorted,
    # then walk the per-step skip chains — each hop is one integer jump,
    # so the Python loop is O(n_closes + steps-containing-bounds), not
    # O(hooks).  Streams where a hook lands within 1e-9 below a boundary
    # would make the legacy loop spin forever re-closing the same hook;
    # the chain's forced progress closes such a hook once instead.
    g_end = float(offs[-1])
    step_end = offs[1:]
    m_first = np.floor(offs[:-1] / I) + 1.0
    # conservative last multiple (exact mask below fixes +-1ulp division)
    m_last = np.floor((step_end + 1e-9) / I) + 1.0
    n_bnd = np.maximum((m_last - m_first + 1.0).astype(np.int64), 0)
    n_bnd[lens == 0] = 0                 # empty step stream: nothing closes
    close_pos_l: List[int] = []
    if N and n_bnd.any():
        swb = np.flatnonzero(n_bnd)                  # steps with bounds
        cnts = n_bnd[swb]
        run0 = np.cumsum(cnts) - cnts                # candidate offset/step
        s_of = np.repeat(swb, cnts)
        m = m_first[s_of] + (np.arange(len(s_of)) - np.repeat(run0, cnts))
        bounds = m * I
        ok = bounds <= step_end[s_of] + 1e-9         # exact legacy test
        cand = np.searchsorted(absu, bounds - 1e-9, side="left")
        np.clip(cand, hook0[s_of], hook0[s_of + 1] - 1, out=cand)
        m_skip = np.floor(absu[cand] / I + 1e-12)
        cand_l, ok_l = cand.tolist(), ok.tolist()
        skip_l, mf_l = m_skip.tolist(), m_first[swb].tolist()
        for t, (i0, c) in enumerate(zip(run0.tolist(), cnts.tolist())):
            i, end, off0 = i0, i0 + c, i0 - int(mf_l[t])
            last_j = -1
            while i < end and ok_l[i]:
                j = cand_l[i]
                if j != last_j:
                    close_pos_l.append(j)
                    last_j = j
                i = max(off0 + int(skip_l[i]) + 1, i + 1)
    close_pos = np.array(close_pos_l, np.int64)
    n_cl = len(close_pos)
    e_arr = absu[close_pos] if n_cl else np.zeros(0)
    s_arr = np.searchsorted(hook0, close_pos, side="right") - 1
    jl_arr = close_pos - hook0[s_arr]

    # ---- per-interval segment reductions ---------------------------------
    seg_len = np.diff(np.concatenate([[-1], close_pos, [N - 1]]))
    # flattened (interval, block) key of every hook -> one bincount gives
    # the whole BBV matrix (last row = trailing open interval)
    key = np.repeat(np.arange(n_cl + 1, dtype=np.int64) * n, seg_len) + ids
    counts_int = np.bincount(key, minlength=(n_cl + 1) * n) \
        .reshape(n_cl + 1, n)
    counts = counts_int.astype(np.float64)

    # hits-at-last-execution has a closed form: the last execution of a
    # block inside an interval is by definition its latest one, so the
    # cumulative hit count there == baseline + row-cumsum of the counts
    hits = np.where(counts_int > 0,
                    baseline_hits[None, :] + np.cumsum(counts_int, axis=0),
                    np.int64(0))

    # last-execution stamp per (interval, block): one in-order flat fancy
    # scatter — repeated indices keep the last value written, the same
    # last-write-wins property the legacy _consume() relies on
    stamps = np.full((n_cl + 1) * n, -1.0)
    if N:
        stamps[key] = absu
    stamps = stamps.reshape(n_cl + 1, n)

    # ---- per-close scalars (ends, markers, virtual contributions) --------
    end_uow = e_arr
    end_step = ((step0 + s_arr).astype(np.float64)
                + (jl_arr + 1) / lens[s_arr]) if n_cl else np.zeros(0)
    marker_block = ids[close_pos] if n_cl else np.zeros(0, np.int64)
    marker_hits = hits[np.arange(n_cl), marker_block]

    dyn_add: List[Tuple[int, int, float]] = []
    virtual = [(i, b) for i, b in enumerate(table.blocks) if b.virtual]
    if n_cl and virtual and any(d for _, d in steps):
        prev_e: Optional[float] = None
        prev_s: Optional[int] = None
        for r, (e, s) in enumerate(zip(e_arr.tolist(), s_arr.tolist())):
            dyn = steps[s][1]
            if dyn:
                cur = tot_of[kinds[s]]
                gs = float(offs[s])
                # legacy frac = min(1, (e - max(ivl_start, step_start))/cur):
                # the previous close is only ever > step_start when it
                # happened inside the same step; otherwise (earlier step /
                # earlier chunk / run start) the max resolves to step start.
                start = prev_e if (prev_s == s and prev_e is not None) else gs
                frac = min(1.0, (e - max(start, gs)) / cur) if cur else 0.0
                for i, blk in virtual:
                    if blk.dyn_key in dyn:
                        v = np.asarray(dyn[blk.dyn_key], np.float64)
                        val = v[blk.dyn_index] \
                            if (blk.dyn_index >= 0 and v.ndim) else v
                        dyn_add.append((r, i, float(val) * max(frac, 0.0)))
            prev_e, prev_s = e, s

    hits_end = base          # baseline + per-kind static counts, all integer
    return ChunkResult(counts=counts, stamps=stamps, hits=hits,
                       end_uow=end_uow, end_step=end_step,
                       marker_block=marker_block, marker_hits=marker_hits,
                       dyn_add=dyn_add, g_end=g_end, hits_end=hits_end,
                       n_steps=len(steps))


# ---------------------------------------------------------------------------
# parallel chunked analysis
# ---------------------------------------------------------------------------

def chunk_starts(table: BlockTable, steps: Sequence[Step],
                 bounds: Sequence[Tuple[int, int]], *, g0: float = 0.0,
                 baseline_hits: Optional[np.ndarray] = None
                 ) -> List[Tuple[float, np.ndarray]]:
    """Exact (global counter, baseline hit counts) at each chunk start.

    Both are cheap closed forms: the counter is the running sum of static
    per-step totals (same float op order as the legacy path); the baselines
    are integer sums of the static per-kind execution counts.
    ``g0``/``baseline_hits`` position the whole stream inside a larger run
    (a builder finalizing only its un-analyzed suffix).
    """
    kinds = [k for k, _ in steps]
    tot_of = {k: table.step_uow(k) for k in set(kinds)}
    cnt_of = {k: table.step_counts(k) for k in set(kinds)}
    tots = np.empty(len(steps) + 1)
    tots[0] = float(g0)
    for s, k in enumerate(kinds):
        tots[s + 1] = tot_of[k]
    offs = np.cumsum(tots)
    out: List[Tuple[float, np.ndarray]] = []
    base = (np.zeros(table.n_blocks, np.int64) if baseline_hits is None
            else baseline_hits.astype(np.int64, copy=True))
    done = 0
    for a, b in bounds:
        assert a == done, "chunks must partition the step stream in order"
        out.append((float(offs[a]), base.copy()))
        for s in range(a, b):
            base += cnt_of[kinds[s]]
        done = b
    return out


def analyze_steps_parallel(table: BlockTable, interval_uow: float,
                           steps: Sequence[Step], *,
                           chunk_steps: Optional[int] = None,
                           max_workers: Optional[int] = None,
                           g0: float = 0.0, step0: int = 0,
                           baseline_hits: Optional[np.ndarray] = None
                           ) -> List[Tuple[ChunkResult, Sequence[Step]]]:
    """Fan the step stream out over a thread pool in whole-step chunks.

    Returns the per-chunk results in stream order, ready to be absorbed
    sequentially (the merge is associative; see module docstring).
    ``g0``/``step0``/``baseline_hits`` position the stream inside a larger
    run, so a builder with prior state can shard just its pending suffix.
    """
    n_steps = len(steps)
    workers = max_workers or min(32, (os.cpu_count() or 2))
    if chunk_steps is None:
        chunk_steps = max(1, -(-n_steps // (4 * workers)))
    bounds = [(a, min(a + chunk_steps, n_steps))
              for a in range(0, n_steps, chunk_steps)]
    starts = chunk_starts(table, steps, bounds, g0=g0,
                          baseline_hits=baseline_hits)

    def _chunk(a: int, b: int, g: float, base: np.ndarray) -> ChunkResult:
        obs.set_worker(_threading.current_thread().name)
        return analyze_steps(table, interval_uow, steps[a:b],
                             g0=g, step0=step0 + a, baseline_hits=base)

    table.expand_all()        # warm the per-kind cache before threads race
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="intervals") as ex:
        futs = [ex.submit(_chunk, a, b, g, base)
                for (a, b), (g, base) in zip(bounds, starts)]
        return [(f.result(), steps[a:b])
                for f, (a, b) in zip(futs, bounds)]
