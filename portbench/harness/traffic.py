"""One general generator for every traffic mix, driven by the mix's file.

Serving mixes are open loops: requests arrive on a schedule whatever the
system does.  The schedule is part of the mix, a replayed trace: output
lengths and gaps between arrivals at evenly spaced quantiles of the mix's
distributions (a pool), in an order drawn from the mix's own
``schedule_seed``.  The run's seed draws the prompts (and the weights), so
a seed changes what is computed and never how much.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Arrival:
    index: int
    due_s: float              # seconds after the schedule's start
    prompt: np.ndarray        # int32 token ids
    max_new_tokens: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def output_lengths(t: dict, n: int) -> np.ndarray:
    """``n`` output lengths at evenly spaced quantiles of the mix's
    distribution, clipped to [lo, hi]."""
    o = t["output"]
    q = _quantiles(n)
    if o["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        v = o["median"] * np.exp(o["sigma"] * z)
    elif o["dist"] == "uniform":
        v = o["lo"] + q * (o["hi"] + 1 - o["lo"])
    else:
        raise ValueError(f"unknown output distribution {o['dist']!r}")
    return np.clip(np.floor(v), o["lo"], o["hi"]).astype(np.int64)


def gaps(t: dict, n: int) -> np.ndarray:
    """``n`` gaps between arrivals at the mix's rate: evenly spaced
    quantiles of the exponential (Poisson arrivals)."""
    return -np.log1p(-_quantiles(n)) / t["rate_per_s"]


def schedule(t: dict, seed: int, vocab: int, n: int) -> List[Arrival]:
    """The first ``n`` arrivals of the mix: the pool of ``t["pool"]``
    lengths and gaps permuted by the mix's ``schedule_seed`` (cycled with a
    new permutation each time round); prompts of ``t["prompt_len"]`` ids
    drawn from ``seed``, uniformly over the vocabulary."""
    pool = t["pool"]
    rng = np.random.default_rng(np.random.SeedSequence(
        [t["schedule_seed"], 1]))
    lens, gs = output_lengths(t, pool), gaps(t, pool)
    out_len, out_gap = [], []
    while len(out_len) < n:
        out_len += list(rng.permutation(lens))
        out_gap += list(rng.permutation(gs))
    prompts = np.random.default_rng(np.random.SeedSequence([seed, 2])).integers(
        0, vocab, size=(n, t["prompt_len"]), dtype=np.int64).astype(np.int32)
    due = np.cumsum([0.0] + out_gap[:n - 1])
    return [Arrival(i, float(due[i]), prompts[i], int(out_len[i]))
            for i in range(n)]


def arrivals_needed(t: dict, seconds: float) -> int:
    """Enough arrivals for the pre-roll, the window and the traced slice
    after it, with room: twice the mean count, at least one pool."""
    span = t["preroll_s"] + seconds
    return max(t["pool"], int(math.ceil(2 * span * t["rate_per_s"])) + 16)
