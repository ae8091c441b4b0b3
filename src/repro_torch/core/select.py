# Counterpart of src/repro/core/select.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Sample-selection methodologies (paper §IV-B1).

The framework is selector-agnostic (the paper's point); three built-ins:

- ``RandomSelector``  — uniform interval sampling, equal weights [49/SMARTS-
  style statistical baseline].
- ``KMeansSelector``  — k-means over (normalized, random-projected) BBVs with
  silhouette-selected k <= 50 and cluster-size weights [SimPoint lineage].
- ``SystematicSelector`` — every n-th interval (periodic systematic sampling).

Each returns a :class:`Selection`: representative interval ids + weights
(weights sum to 1 over the whole run).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.intervals import Profile
from repro_torch.core.kmeans import (kmeans, pick_k_silhouette, random_projection,
                               silhouette)


@dataclasses.dataclass
class Selection:
    method: str
    interval_ids: List[int]
    weights: np.ndarray              # per selected interval, sums to 1
    assignment: Optional[np.ndarray] = None   # cluster id per interval

    def to_json(self):
        return {"method": self.method,
                "interval_ids": [int(i) for i in self.interval_ids],
                "weights": self.weights.tolist(),
                "assignment": (self.assignment.tolist()
                               if self.assignment is not None else None)}

    @staticmethod
    def from_json(d):
        return Selection(d["method"], d["interval_ids"],
                         np.asarray(d["weights"]),
                         np.asarray(d["assignment"])
                         if d.get("assignment") is not None else None)


def normalize_bbvs(profile: Profile) -> np.ndarray:
    x = profile.bbv_matrix().astype(np.float64)
    row = x.sum(axis=1, keepdims=True)
    row[row == 0] = 1.0
    return x / row


class RandomSelector:
    def __init__(self, n_samples: int = 50, seed: int = 0):
        self.n_samples, self.seed = n_samples, seed

    def select(self, profile: Profile) -> Selection:
        n = profile.n_intervals
        rng = np.random.default_rng(self.seed)
        k = min(self.n_samples, n)
        ids = sorted(rng.choice(n, k, replace=False).tolist())
        w = np.full(k, 1.0 / k)
        return Selection("random", ids, w)


class SystematicSelector:
    def __init__(self, n_samples: int = 50, offset: int = 0):
        self.n_samples, self.offset = n_samples, offset

    def select(self, profile: Profile) -> Selection:
        n = profile.n_intervals
        k = min(self.n_samples, n)
        stride = max(1, n // k)
        ids = list(range(self.offset % stride, n, stride))[:k]
        w = np.full(len(ids), 1.0 / len(ids))
        return Selection("systematic", ids, w)


class KMeansSelector:
    def __init__(self, max_k: int = 50, seed: int = 0, project_dim: int = 15,
                 fixed_k: Optional[int] = None,
                 n_workers: Optional[int] = None):
        self.max_k, self.seed, self.project_dim = max_k, seed, project_dim
        self.fixed_k = fixed_k
        self.n_workers = n_workers       # thread-pool width for the k-sweep

    def select(self, profile: Profile) -> Selection:
        x = normalize_bbvs(profile)
        xp = random_projection(x, self.project_dim, self.seed)
        n = xp.shape[0]
        if self.fixed_k is not None:
            k = min(self.fixed_k, n)
            assign, centers, _ = kmeans(xp, k, seed=self.seed)
        else:
            k, assign, centers = pick_k_silhouette(
                xp, self.max_k, self.seed, n_workers=self.n_workers)
        ids, weights = [], []
        for c in range(k):
            members = np.nonzero(assign == c)[0]
            if len(members) == 0:
                continue
            d2 = np.sum((xp[members] - centers[c]) ** 2, axis=1)
            ids.append(int(members[np.argmin(d2)]))
            weights.append(len(members) / n)
        order = np.argsort(ids)
        ids = [ids[i] for i in order]
        weights = np.asarray([weights[i] for i in order])
        return Selection("kmeans", ids, weights, assignment=assign)


SELECTORS = {
    "random": RandomSelector,
    "kmeans": KMeansSelector,
    "systematic": SystematicSelector,
}
