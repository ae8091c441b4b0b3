"""Batched serving with continuous batching + heterogeneous Nugget profiling,
on the port.

Prefill and decode iterations emit different hook streams; the interval
profile mixes them — serving is the naturally phase-rich workload class.

    PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import KMeansSelector  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import ServeEngine, SyntheticRequests  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    cfg = reduced(get_config("qwen3-1.7b"))
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(0))

    eng = ServeEngine(cfg, batch=4, max_seq=96, prefill_len=16,
                      interval_steps=3.0, device=args.device)
    gen = SyntheticRequests(cfg.vocab_size, prompt_len=12, mean_new=16,
                            seed=0)
    stats = eng.run(params, [gen.request(i) for i in range(12)])
    print("serving stats:",
          {k: round(v, 3) if isinstance(v, float) else v
           for k, v in stats.items()})

    profile = eng.profile()
    mix = {k: eng.kinds_log.count(k) for k in set(eng.kinds_log)}
    print(f"engine iterations by kind: {mix}")
    print(f"intervals: {profile.n_intervals} "
          f"(uow/step: prefill={profile.table.step_uow('prefill'):.0f}, "
          f"decode={profile.table.step_uow('decode'):.0f})")
    sel = KMeansSelector(seed=0).select(profile)
    print(f"k-means picked {len(sel.interval_ids)} representative intervals "
          f"with weights {[round(float(w), 2) for w in sel.weights]}")
    return stats, profile, sel


if __name__ == "__main__":
    main()
