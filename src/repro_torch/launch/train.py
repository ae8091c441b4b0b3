# Counterpart of src/repro/launch/train.py; nothing of it is left unported.
# It adds `--device`, and the spec of the profile it persists names the
# backend and the device, as the pipeline's platform specs do.
"""Training launcher.

Runs on the card; `--device cpu` is the only way onto the CPU.  It trains
with the chunked attention and SSD (the JAX package's training defaults):
the CUDA kernels have no backward.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 6 --seq-len 512 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 6 --device cpu --profile-out /tmp/prof
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-feasible)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--interval-steps", type=float, default=2.0)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--no-instrument", action="store_true")
    ap.add_argument("--profile-out")
    ap.add_argument("--profile-cache",
                    help="content-addressed profile cache directory: "
                         "identical (table, interval, step stream) runs "
                         "load the stored profile instead of re-analyzing")
    ap.add_argument("--no-defer-analysis", action="store_true",
                    help="legacy per-step interval analysis (the default "
                         "defers: log steps during training, batch-analyze "
                         "at the end with the vectorized path)")
    ap.add_argument("--store",
                    help="ArtifactStore root: persist the profile as a "
                         "content-addressed pipeline artifact")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    from repro_torch import obs
    obs.log.setup()                       # key=value lines, REPRO_LOG_LEVEL
    obs.configure_from_env()              # spans if REPRO_TRACE is set

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import config_dict
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train import Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=4, d_model=128, d_ff=256, vocab=1024,
                      seq=args.seq_len)
    cfg = dataclasses.replace(cfg, attention_impl="chunked",
                              ssm_impl="chunked")
    tr = Trainer(cfg, seq_len=args.seq_len, batch=args.batch,
                 opt=AdamWConfig(lr=args.lr),
                 lr_fn=linear_warmup_cosine(args.lr, args.steps // 10 + 1,
                                            args.steps),
                 seed=args.seed,
                 instrument=not args.no_instrument,
                 interval_steps=args.interval_steps,
                 microbatch=args.microbatch,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 defer_analysis=not args.no_defer_analysis,
                 device=args.device)
    tr.run(args.steps, log_every=args.log_every)
    out = {
        "final_loss": tr.metrics_history[-1]["loss"],
        "mean_step_s": sum(tr.step_times[1:]) / max(len(tr.step_times) - 1, 1),
        "stragglers": tr.watchdog_report().slow_steps,
    }
    print(json.dumps(out, indent=1))
    if (args.profile_out or args.profile_cache or args.store) \
            and not args.no_instrument:
        from repro_torch.pipeline import persist_profile_cli
        persist_profile_cli(
            tr.builder, profile_out=args.profile_out,
            profile_cache=args.profile_cache, store=args.store,
            spec={"arch": config_dict(cfg), "kind": "train",
                  "seq_len": args.seq_len, "batch": args.batch,
                  "steps": args.steps, "seed": args.seed,
                  "interval_steps": args.interval_steps,
                  "backend": "torch", "device": args.device})
    return out


if __name__ == "__main__":
    main()
