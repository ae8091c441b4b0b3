# Counterpart of src/repro/data/synthetic.py: a verbatim copy (numpy / stdlib
# only); nothing of it is left unported.
"""Deterministic phased synthetic corpus.

Real sampling targets (SPEC ref inputs, LSMS Fe) derive their phase structure
from input data; our corpus induces phases the same way: the token stream
switches between *domains* (disjoint vocab bands + Zipf exponents + length
mixes) on a schedule.  Domain changes shift MoE routing and loss statistics,
so interval BBVs show real phase structure for the selectors to find.

Generation is *stateless*: ``batch_at(step)`` is a pure function of
(seed, step), which makes checkpoint-resume and nugget replay exactly
reproducible — the data cursor is just the step index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Domain:
    name: str
    vocab_lo: float        # fraction of vocab where this domain's band starts
    vocab_hi: float
    zipf_a: float          # Zipf exponent (higher = more skewed)
    mean_len: int          # mean document length (for packing stats)


DEFAULT_DOMAINS = (
    Domain("web", 0.00, 0.50, 1.2, 512),
    Domain("code", 0.45, 0.80, 1.05, 1024),
    Domain("math", 0.75, 1.00, 1.4, 256),
    Domain("dialog", 0.10, 0.35, 1.3, 128),
)


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """Which domain mix is active at a given step (piecewise-constant with
    optional cycling — gives the run SimPoint-style recurring phases)."""
    spans: Tuple[Tuple[int, Tuple[float, ...]], ...]  # (length, domain mix)
    cycle: bool = True

    def mix_at(self, step: int) -> Tuple[float, ...]:
        total = sum(s for s, _ in self.spans)
        s = step % total if self.cycle else min(step, total - 1)
        acc = 0
        for length, mix in self.spans:
            acc += length
            if s < acc:
                return mix
        return self.spans[-1][1]


def default_schedule(n_domains: int = 4) -> PhaseSchedule:
    e = np.eye(n_domains)
    mixes = []
    for i in range(n_domains):
        m = 0.7 * e[i] + 0.3 / n_domains
        mixes.append(tuple(m / m.sum()))
    blend = tuple(np.full(n_domains, 1.0 / n_domains))
    spans = tuple([(24, mixes[i]) for i in range(n_domains)] + [(16, blend)])
    return PhaseSchedule(spans)


class SyntheticCorpus:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, domains=DEFAULT_DOMAINS,
                 schedule: Optional[PhaseSchedule] = None,
                 n_frames: int = 0, d_model: int = 0, n_patches: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.domains = domains
        self.schedule = schedule or default_schedule(len(domains))
        self.n_frames, self.d_model, self.n_patches = n_frames, d_model, n_patches

    # ------------------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def _domain_tokens(self, rng, d: Domain, n: int) -> np.ndarray:
        lo = int(d.vocab_lo * self.vocab_size)
        hi = max(lo + 2, int(d.vocab_hi * self.vocab_size))
        band = hi - lo
        # bounded-Zipf via inverse-CDF on ranks
        ranks = np.arange(1, band + 1, dtype=np.float64)
        w = ranks ** (-d.zipf_a)
        w /= w.sum()
        return lo + rng.choice(band, size=n, p=w)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        mix = np.asarray(self.schedule.mix_at(step))
        b, s = self.global_batch, self.seq_len
        dom_per_row = rng.choice(len(self.domains), size=b, p=mix / mix.sum())
        toks = np.empty((b, s + 1), np.int32)
        for i, di in enumerate(dom_per_row):
            toks[i] = self._domain_tokens(rng, self.domains[di], s + 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "domains": dom_per_row.astype(np.int32)}
        if self.n_frames:
            out["frames"] = rng.standard_normal(
                (b, self.n_frames, self.d_model)).astype(np.float32)
        if self.n_patches:
            out["patches"] = rng.standard_normal(
                (b, self.n_patches, self.d_model)).astype(np.float32)
        return out

    def token_stats(self, step: int) -> Dict[str, float]:
        """Cheap per-step signature extras for the Nugget profile."""
        mix = np.asarray(self.schedule.mix_at(step))
        return {f"domain_mix_{i}": float(m) for i, m in enumerate(mix)}
