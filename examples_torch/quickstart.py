"""Quickstart on the port: the whole Nugget pipeline in ~60 lines (paper
Fig. 1).

Train a small instrumented model, discover intervals, select representative
samples two ways, create nuggets, replay them natively, and compare the
predicted full-run time against the measured ground truth.  Training runs
the chunked attention (the kernels have no backward), as the JAX package
trains.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (KMeansSelector, RandomSelector,  # noqa: E402
                              ReplayEngine, create_nuggets, measure_full_run,
                              predict_total_time, prediction_error)
from repro_torch.train import Trainer  # noqa: E402

N_STEPS = 40


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              attention_impl="chunked", ssm_impl="chunked")
    with tempfile.TemporaryDirectory() as ckdir:
        print(f"== training {cfg.name} (reduced) for {N_STEPS} steps, "
              "hooks ON")
        tr = Trainer(cfg, seq_len=32, batch=4, ckpt_dir=ckdir, ckpt_every=10,
                     interval_steps=2.5, device=args.device)
        tr.run(N_STEPS)

        profile = tr.profile()
        print(f"== interval analysis: {profile.n_intervals} intervals, "
              f"{profile.total_uow:.0f} ATen ops of work, "
              f"blocks={profile.table.names[:4]}...")

        runner = tr.make_runner()
        engine = ReplayEngine(runner, profile)
        actual = measure_full_run(runner, N_STEPS)

        for name, selector in (("random", RandomSelector(n_samples=8, seed=0)),
                               ("kmeans", KMeansSelector(seed=0))):
            sel = selector.select(profile)
            nuggets = create_nuggets(profile, sel, warmup_intervals=1,
                                     ckpt_every=10)
            results = engine.replay_all(nuggets)
            pred = predict_total_time(profile, results)
            err = prediction_error(pred, actual)
            print(f"== {name:7s}: {len(nuggets):2d} nuggets | "
                  f"predicted {pred:6.2f}s vs actual {actual:6.2f}s | "
                  f"error {err:+.1%}")


if __name__ == "__main__":
    main()
