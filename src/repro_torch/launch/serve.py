# Counterpart of src/repro/launch/serve.py; nothing of it is left unported.
# It adds `--device`, and the spec of the profile it persists names the
# backend and the device, as the pipeline's platform specs do.
"""Serving launcher (batched requests, continuous batching).

Runs on the card; `--device cpu` is the only way onto the CPU.  The first
call on the card builds the CUDA kernels.  The dense (qwen3-1.7b, ...), SSM
(mamba2-780m) and hybrid (zamba2-1.2b) families are served.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --requests 16 --prefill-len 512 --max-seq 1024
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-out")
    ap.add_argument("--profile-cache",
                    help="content-addressed profile cache directory")
    ap.add_argument("--store",
                    help="ArtifactStore root: persist the profile as a "
                         "content-addressed pipeline artifact")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--no-defer-analysis", action="store_true",
                    help="legacy per-step interval analysis (the default "
                         "defers: log steps while serving, batch-analyze "
                         "at the end with the vectorized path)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import obs
    obs.log.setup()                       # key=value lines, REPRO_LOG_LEVEL
    obs.configure_from_env()              # spans if REPRO_TRACE is set

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import config_dict
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeEngine, SyntheticRequests

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=4, d_model=128, d_ff=256, vocab=1024)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    eng = ServeEngine(cfg, batch=args.batch, max_seq=args.max_seq,
                      prefill_len=args.prefill_len,
                      temperature=args.temperature, seed=args.seed,
                      defer_analysis=not args.no_defer_analysis,
                      device=args.device)
    gen = SyntheticRequests(cfg.vocab_size, prompt_len=args.prefill_len,
                            mean_new=24, seed=args.seed)
    stats = eng.run(params, [gen.request(i) for i in range(args.requests)])
    print(json.dumps(stats, indent=1))
    if args.profile_out or args.profile_cache or args.store:
        from repro_torch.pipeline import persist_profile_cli
        persist_profile_cli(
            eng.builder, profile_out=args.profile_out,
            profile_cache=args.profile_cache, store=args.store,
            spec={"arch": config_dict(cfg), "kind": "serve",
                  "requests": args.requests, "batch": args.batch,
                  "max_seq": args.max_seq, "prefill_len": args.prefill_len,
                  "temperature": args.temperature, "seed": args.seed,
                  "backend": "torch", "device": args.device})
    return stats


if __name__ == "__main__":
    main()
