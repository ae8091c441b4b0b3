# Counterpart of src/repro/core/validate.py: a verbatim copy (numpy only; ``full_run_baseline``
# calls the port's ``measure_full_run``) with the package renamed in its
# imports; nothing of it is left unported.
"""Sample validation: weighted extrapolation, prediction error, speedup
error, and the cross-platform consistency analysis the paper identifies as
the strongest quality signal (§IV-B2, §V-A).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.intervals import Profile
from repro_torch.core.nugget import Nugget
from repro_torch.core.replay import ReplayResult, StepRunner, measure_full_run


def predict_total_time(profile: Profile, results: Sequence[ReplayResult]
                       ) -> float:
    """Predicted full-run time = n_intervals * sum_i w_i * t_i  (cluster-size
    weights; SimPoint-style extrapolation)."""
    n = profile.n_intervals
    return n * float(sum(r.weight * r.region_time_s for r in results))


def prediction_error(predicted: float, actual: float) -> float:
    return (predicted - actual) / actual


@dataclasses.dataclass
class PlatformResult:
    platform: str
    predicted: float
    actual: float

    @property
    def error(self) -> float:
        return prediction_error(self.predicted, self.actual)


def speedup_error_matrix(platforms: List[PlatformResult]
                         ) -> List[Dict[str, float]]:
    """Paper §V-A: error in *predicted speedup* for every platform pair —
    usually far tighter than absolute-runtime error."""
    out = []
    for a, b in itertools.combinations(platforms, 2):
        true_sp = a.actual / b.actual
        pred_sp = a.predicted / b.predicted
        out.append({
            "pair": f"{a.platform}|{b.platform}",
            "true_speedup": true_sp,
            "pred_speedup": pred_sp,
            "abs_speedup_error": abs(pred_sp - true_sp) / true_sp,
        })
    return out


def consistency_report(platforms: List[PlatformResult]) -> Dict[str, float]:
    """Cross-platform consistency (paper: 'consistent prediction error across
    platforms is a stronger indicator of sample quality than low error on a
    single platform')."""
    errs = np.array([p.error for p in platforms])
    return {
        "mean_abs_error": float(np.mean(np.abs(errs))),
        "error_spread": float(errs.max() - errs.min()) if len(errs) else 0.0,
        "error_std": float(errs.std()),
        "consistent": bool(errs.std() < 0.05),
    }


def per_nugget_matrix(results_by_platform: Dict[str, List[ReplayResult]]
                      ) -> Tuple[np.ndarray, List[str], List[int]]:
    """[n_platforms, n_nuggets] region times — the Fig. 7 distribution data."""
    plats = sorted(results_by_platform)
    ids = [r.nugget_id for r in results_by_platform[plats[0]]]
    mat = np.array([[r.region_time_s for r in results_by_platform[p]]
                    for p in plats])
    return mat, plats, ids


def nugget_variability(results_by_platform: Dict[str, List[ReplayResult]]
                       ) -> List[Dict[str, float]]:
    """Flag nuggets whose relative cost varies most across platforms
    (candidates for 'not representative of the true speedup')."""
    mat, plats, ids = per_nugget_matrix(results_by_platform)
    rel = mat / mat.sum(axis=1, keepdims=True)
    out = []
    for j, nid in enumerate(ids):
        out.append({"nugget_id": int(nid),
                    "rel_cost_spread": float(rel[:, j].max() - rel[:, j].min()),
                    "rel_cost_mean": float(rel[:, j].mean())})
    return sorted(out, key=lambda d: -d["rel_cost_spread"])


def full_run_baseline(runner: StepRunner, n_steps: int,
                      *, start: int = 0) -> Dict[str, float]:
    """Validation-side ground truth for one platform, as a JSON-able record.

    All full-run measurement for validation flows through here (and so
    becomes a cacheable artifact) instead of being re-measured ad hoc per
    example/benchmark."""
    return {"n_steps": int(n_steps),
            "actual_s": float(measure_full_run(runner, n_steps, start=start))}


def platform_results(profile: Profile,
                     results_by_platform: Dict[str, List[ReplayResult]],
                     baselines: Dict[str, Dict[str, float]]
                     ) -> List[PlatformResult]:
    """Assemble per-platform predicted-vs-actual pairs from replay-result
    lists and :func:`full_run_baseline` records (platform order preserved)."""
    return [PlatformResult(p, predict_total_time(profile, results_by_platform[p]),
                           float(baselines[p]["actual_s"]))
            for p in results_by_platform]


def validation_report(profile: Profile,
                      results_by_platform: Dict[str, List[ReplayResult]],
                      baselines: Dict[str, Dict[str, float]]) -> Dict:
    """The full §V-A validation summary as one JSON-able dict: per-platform
    prediction error, pairwise speedup errors, cross-platform consistency,
    and per-nugget variability."""
    plats = platform_results(profile, results_by_platform, baselines)
    have_results = all(results_by_platform.values())
    return {
        "platforms": {p.platform: {"predicted_s": p.predicted,
                                   "actual_s": p.actual,
                                   "error": p.error} for p in plats},
        "speedup_errors": speedup_error_matrix(plats) if len(plats) > 1 else [],
        "consistency": consistency_report(plats),
        "nugget_variability": (nugget_variability(results_by_platform)
                               if have_results else []),
    }


def signature_divergence(profile_a: Profile, profile_b: Profile
                         ) -> Dict[str, float]:
    """Cross-platform signature stability (paper §IV-A2: LSMS fp-precision
    loop-count divergence).  Compares per-interval BBVs of two profiles of
    the same workload collected on different platforms."""
    na, nb = profile_a.n_intervals, profile_b.n_intervals
    n = min(na, nb)
    if n == 0:
        return {"intervals_compared": 0, "max_rel_divergence": 0.0,
                "mean_rel_divergence": 0.0, "interval_count_delta": abs(na - nb)}
    A = profile_a.bbv_matrix()[:n]
    B = profile_b.bbv_matrix()[:n]
    denom = np.maximum(np.abs(A) + np.abs(B), 1.0)
    rel = np.abs(A - B) / denom
    return {
        "intervals_compared": n,
        "max_rel_divergence": float(rel.max()),
        "mean_rel_divergence": float(rel.mean()),
        "interval_count_delta": abs(na - nb),
    }
