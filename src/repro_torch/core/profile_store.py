# Counterpart of src/repro/core/profile_store.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""On-disk profile artifacts: interval profiles, selections, nuggets, replay
results.  Directory layout::

    <dir>/profile.npz      # bbvs, stamps, uows, markers, dyn history
    <dir>/table.json       # BlockTable
    <dir>/meta.json        # interval size, totals
    <dir>/nuggets_<m>.json # per selection method
    <dir>/results_<m>_<platform>.json

Content-addressed profile cache (``cached_build`` / ``cached_finalize``)::

    <cache_dir>/<key>/     # one save_profile() directory per cache key

The cache key is the sha256 of everything the analysis depends on — the
canonical BlockTable JSON (sorted keys), the interval size, and a digest of
the step stream (per-step kind plus the raw bytes of every dynamic aux
array, keys sorted).  Profiling the same stream twice therefore loads the
stored Profile instead of re-analyzing; any change to the table, interval
size, step kinds or dyn values changes the key and misses.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.intervals import (Interval, IntervalBuilder, Marker, Profile,
                                  build_profile)
from repro_torch.core.intervals_vec import Step
from repro_torch.core.registry import BlockTable


def save_profile(dirpath: str, profile: Profile) -> None:
    os.makedirs(dirpath, exist_ok=True)
    ivs = profile.intervals
    nb = profile.table.n_blocks
    # zero-interval profiles keep the block dimension so a round trip
    # preserves bbv_matrix().shape == (0, n_blocks)
    np.savez_compressed(
        os.path.join(dirpath, "profile.npz"),
        bbvs=np.stack([iv.bbv for iv in ivs]) if ivs else np.zeros((0, nb)),
        stamps=np.stack([iv.stamps for iv in ivs]) if ivs else np.zeros((0, nb)),
        hits_at=np.stack([iv.hits_at_stamp for iv in ivs]) if ivs
        else np.zeros((0, nb), np.int64),
        start_uow=np.array([iv.start_uow for iv in ivs]),
        end_uow=np.array([iv.end_uow for iv in ivs]),
        start_step=np.array([iv.start_step for iv in ivs]),
        end_step=np.array([iv.end_step for iv in ivs]),
        marker_block=np.array([iv.end_marker.block for iv in ivs], np.int64),
        marker_hits=np.array([iv.end_marker.hits for iv in ivs], np.int64),
        marker_uow=np.array([iv.end_marker.uow for iv in ivs]),
        **{f"dyn_{k}": v for k, v in profile.dyn_history.items()},
    )
    with open(os.path.join(dirpath, "table.json"), "w") as f:
        json.dump(profile.table.to_json(), f)
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump({"interval_uow": profile.interval_uow,
                   "total_uow": profile.total_uow,
                   "n_steps": profile.n_steps,
                   "step_uow": profile.step_uow}, f)


def load_profile(dirpath: str) -> Profile:
    with open(os.path.join(dirpath, "table.json")) as f:
        table = BlockTable.from_json(json.load(f))
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(dirpath, "profile.npz"))
    # NpzFile members decompress on every [] access — pull each array out
    # exactly once before the per-interval loop
    bbvs, stamps, hits_at = z["bbvs"], z["stamps"], z["hits_at"]
    start_uow, end_uow = z["start_uow"].tolist(), z["end_uow"].tolist()
    start_step, end_step = z["start_step"].tolist(), z["end_step"].tolist()
    marker_block = z["marker_block"].tolist()
    marker_hits = z["marker_hits"].tolist()
    marker_uow = z["marker_uow"].tolist()
    intervals = []
    for i in range(len(start_uow)):
        intervals.append(Interval(
            idx=i,
            start_uow=start_uow[i],
            end_uow=end_uow[i],
            end_marker=Marker(marker_block[i], marker_hits[i],
                              marker_uow[i]),
            bbv=bbvs[i],
            stamps=stamps[i],
            hits_at_stamp=hits_at[i],
            start_step=start_step[i],
            end_step=end_step[i],
        ))
    dyn = {k[4:]: z[k] for k in z.files if k.startswith("dyn_")}
    return Profile(table=table, interval_uow=meta["interval_uow"],
                   intervals=intervals, total_uow=meta["total_uow"],
                   n_steps=meta["n_steps"], step_uow=meta["step_uow"],
                   dyn_history=dyn)


# ---------------------------------------------------------------------------
# content-addressed profile cache
# ---------------------------------------------------------------------------

def stream_digest(steps: Sequence[Step]) -> str:
    """sha256 of a step stream: per-step kind + dyn aux array bytes.

    Dyn dicts hash by sorted key with the value's canonical float64 bytes,
    so dict insertion order does not affect the digest.
    """
    h = hashlib.sha256()
    h.update(str(len(steps)).encode())
    for kind, dyn in steps:
        h.update(b"\x00")
        h.update(kind.encode())
        if dyn:
            for k in sorted(dyn):
                h.update(b"\x01")
                h.update(k.encode())
                v = np.ascontiguousarray(np.asarray(dyn[k], np.float64))
                h.update(str(v.shape).encode())
                h.update(v.tobytes())
    return h.hexdigest()


def profile_cache_key(table: BlockTable, interval_uow: float,
                      steps: Sequence[Step]) -> str:
    """Cache key = hash of everything the interval analysis depends on."""
    h = hashlib.sha256()
    h.update(json.dumps(table.to_json(), sort_keys=True).encode())
    h.update(repr(float(interval_uow)).encode())
    h.update(stream_digest(steps).encode())
    return h.hexdigest()


def cached_build(cache_dir: str, table: BlockTable, interval_uow: float,
                 steps: Sequence[Step], *, method: str = "batch",
                 **kwargs) -> Tuple[Profile, bool]:
    """Build (or load) the Profile of a step stream; returns (profile, hit).

    On a miss the profile is analyzed with :func:`build_profile` and saved
    under ``<cache_dir>/<key>``; on a hit it is loaded from there without
    re-analysis.
    """
    key = profile_cache_key(table, interval_uow, steps)
    path = os.path.join(cache_dir, key)
    if os.path.exists(os.path.join(path, "meta.json")):
        return load_profile(path), True
    profile = build_profile(table, interval_uow, steps, method=method,
                            **kwargs)
    save_profile(path, profile)
    return profile, False


def cached_finalize(cache_dir: str, builder: IntervalBuilder, *,
                    max_workers: Optional[int] = None,
                    chunk_steps: Optional[int] = None
                    ) -> Tuple[Profile, bool]:
    """Cache-aware ``finalize()`` for a builder that logged its steps.

    Uses ``builder.step_log`` as the cache key input; most useful with
    ``IntervalBuilder(..., defer=True)``, where a hit skips the entire
    batch analysis.  ``max_workers > 1`` analyzes a miss through the
    sharded ``finalize_parallel`` path (bit-for-bit identical profile, so
    serial and parallel runs share cache entries).
    """
    key = profile_cache_key(builder.table, builder.interval_uow,
                            builder.step_log)
    path = os.path.join(cache_dir, key)
    if os.path.exists(os.path.join(path, "meta.json")):
        return load_profile(path), True
    if max_workers is not None and max_workers > 1:
        profile = builder.finalize_parallel(chunk_steps=chunk_steps,
                                            max_workers=max_workers)
    else:
        profile = builder.finalize()
    save_profile(path, profile)
    return profile, False
