# Counterpart of src/repro/core/kmeans.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""k-means++ / Lloyd / silhouette, in numpy (no sklearn dependency).

Used by the K-means selector (paper §IV-B1: silhouette-selected k <= 50,
cluster-size weights, SimPoint-style random projection of BBVs).

The Lloyd centroid update and the silhouette score are fully vectorized
(flattened ``bincount`` for per-cluster sums; one distance-matrix matmul
against cluster indicators for per-cluster mean distances), and the
silhouette k-sweep can fan out over a thread pool (numpy releases the GIL;
every candidate k is seeded independently, so the parallel sweep picks the
same k as the sequential one).
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Optional, Tuple

import numpy as np


def kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator
                   ) -> np.ndarray:
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), x.dtype)
    idx = rng.integers(n)
    centers[0] = x[idx]
    d2 = np.sum((x - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0 or not np.isfinite(total):
            idx = rng.integers(n)            # degenerate: identical points
        else:
            idx = rng.choice(n, p=d2 / total)
        centers[i] = x[idx]
        d2 = np.minimum(d2, np.sum((x - centers[i]) ** 2, axis=1))
    return centers


def lloyd(x: np.ndarray, centers: np.ndarray, iters: int = 50
          ) -> Tuple[np.ndarray, np.ndarray, float]:
    k = centers.shape[0]
    assign = np.zeros(x.shape[0], np.int64)
    for _ in range(iters):
        d2 = (np.sum(x * x, 1)[:, None] - 2 * x @ centers.T
              + np.sum(centers * centers, 1)[None])
        new_assign = np.argmin(d2, axis=1)
        if np.array_equal(new_assign, assign) and _ > 0:
            break
        assign = new_assign
        # vectorized centroid update: per-cluster sums via one flattened
        # bincount (deterministic index-order accumulation, no np.add.at);
        # empty clusters keep their previous center
        dim = x.shape[1]
        cnt = np.bincount(assign, minlength=k)
        sums = np.bincount(
            (assign[:, None] * dim + np.arange(dim)[None, :]).ravel(),
            weights=x.ravel(), minlength=k * dim).reshape(k, dim)
        nonempty = cnt > 0
        centers[nonempty] = sums[nonempty] / cnt[nonempty, None]
    inertia = float(np.sum((x - centers[assign]) ** 2))
    return assign, centers, inertia


def kmeans(x: np.ndarray, k: int, *, seed: int = 0, restarts: int = 3
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(restarts):
        c0 = kmeans_pp_init(x, k, rng)
        assign, centers, inertia = lloyd(x, c0.copy())
        if best is None or inertia < best[2]:
            best = (assign, centers, inertia)
    return best


def silhouette(x: np.ndarray, assign: np.ndarray,
               max_points: int = 1500, seed: int = 0) -> float:
    """Mean silhouette; subsampled for O(n^2) tractability."""
    n = x.shape[0]
    k = int(assign.max()) + 1
    if k < 2 or n < 3:
        return -1.0
    rng = np.random.default_rng(seed)
    if n > max_points:
        sel = rng.choice(n, max_points, replace=False)
    else:
        sel = np.arange(n)
    xs, asg = x[sel], assign[sel]
    m = len(sel)
    d = np.sqrt(np.maximum(
        np.sum(xs * xs, 1)[:, None] - 2 * xs @ xs.T + np.sum(xs * xs, 1)[None],
        0.0))
    # per-(point, cluster) distance sums in one matmul against the cluster
    # indicator matrix; a_i divides by (own cluster size - 1) because
    # d[i, i] == 0 contributes nothing, b_i is the min mean distance to a
    # *different* non-empty cluster (empty / own clusters masked to inf)
    onehot = np.zeros((m, k))
    onehot[np.arange(m), asg] = 1.0
    cnt = onehot.sum(axis=0)
    sums = d @ onehot                                   # [m, k]
    own = cnt[asg]
    a = np.where(own > 1, sums[np.arange(m), asg] / np.maximum(own - 1, 1),
                 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean_d = sums / cnt[None, :]
    mean_d[:, cnt == 0] = np.inf
    mean_d[np.arange(m), asg] = np.inf
    b = mean_d.min(axis=1)
    valid = np.isfinite(b)                # point needs another non-empty cluster
    if not valid.any():
        return -1.0
    s = (b[valid] - a[valid]) / np.maximum(np.maximum(a[valid], b[valid]),
                                           1e-30)
    return float(np.mean(s))


def random_projection(x: np.ndarray, dim: int = 15, seed: int = 0
                      ) -> np.ndarray:
    """SimPoint-style BBV dimensionality reduction."""
    if x.shape[1] <= dim:
        return x
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(x.shape[1], dim)) / np.sqrt(dim)
    return x @ proj


def _score_k(x: np.ndarray, k: int, seed: int
             ) -> Tuple[float, int, np.ndarray, np.ndarray]:
    assign, centers, _ = kmeans(x, k, seed=seed)
    return silhouette(x, assign, seed=seed), k, assign, centers


def pick_k_silhouette(x: np.ndarray, max_k: int = 50, seed: int = 0,
                      n_workers: Optional[int] = None
                      ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Silhouette-scored k selection (paper: #clusters <= 50).

    Candidate ks are scored independently (each k re-seeds its own rng), so
    the sweep fans out over a thread pool; the winner is picked by walking
    the candidates in ascending-k order with a strict ``>`` — identical to
    the sequential sweep no matter the completion order.  ``n_workers=1``
    forces the sequential path.
    """
    n = x.shape[0]
    ks = [k for k in sorted(set(min(k, n - 1) for k in
                                [2, 3, 4, 6, 8, 12, 16, 24, 32, 50]
                                if k < n))
          if 2 <= k <= max_k]
    if not ks:
        assign, centers, _ = kmeans(x, min(2, n), seed=seed)
        return min(2, n), assign, centers
    workers = n_workers or min(len(ks), os.cpu_count() or 1)
    if workers > 1:
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            scored = list(ex.map(lambda k: _score_k(x, k, seed), ks))
    else:
        scored = [_score_k(x, k, seed) for k in ks]
    best = scored[0]
    for cand in scored[1:]:
        if cand[0] > best[0]:
            best = cand
    return best[1], best[2], best[3]
