# Counterpart of src/repro/launch/pipeline.py; nothing of it is left
# unported.  It adds `--device` (default cuda), as the port's other
# launchers do.
"""Single entrypoint for the end-to-end sampling pipeline.

Runs profile -> select -> mark -> replay -> validate against a
content-addressed artifact store and emits a JSON run manifest (stage
timings, cache hits, artifact digests, prediction/speedup errors).
Re-running with the same flags hits the cache for every stage; changing
only ``--selector`` re-runs selection and downstream stages while the
profile and baseline artifacts are reused.

With ``--trace DIR`` the run is traced end to end: ``DIR/trace.json`` is a
Chrome-trace/Perfetto file (one span per stage, load it at
https://ui.perfetto.dev), ``DIR/trace.jsonl`` the raw event stream and
``DIR/metrics.json`` the metrics snapshot that is also embedded in the
manifest's ``obs`` block.  Summarize later with
``python -m repro_torch.launch.obs DIR``.

The trainers run on the card; ``--device cpu`` is the only way onto the CPU.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.pipeline --arch qwen3-1.7b \
        --steps 16 --seq-len 256 --batch 4 --interval-steps 2 \
        --platforms bf16,f32 --selector kmeans --store /tmp/artifacts
    PYTHONPATH=src python -m repro_torch.launch.pipeline --arch mamba2-780m \
        --reduced --steps 16 --seq-len 16 --batch 2 --platforms f32 \
        --store /tmp/artifacts --trace /tmp/run-trace --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def build_config(args) -> "PipelineConfig":
    from repro_torch.pipeline import PipelineConfig
    if args.selector == "random":
        selector_args = {"n_samples": args.n_samples,
                         "seed": args.selector_seed}
    elif args.selector == "systematic":
        selector_args = {"n_samples": args.n_samples}
    else:                                   # kmeans
        selector_args = {"seed": args.selector_seed}
        if args.fixed_k:
            selector_args["fixed_k"] = args.fixed_k
    return PipelineConfig(
        arch=args.arch,
        platforms=tuple(p for p in args.platforms.split(",") if p),
        selector=args.selector,
        selector_args=selector_args,
        steps=args.steps, seq_len=args.seq_len, batch=args.batch,
        interval_steps=args.interval_steps, seed=args.seed,
        reduce=args.reduced,
        warmup_intervals=args.warmup_intervals,
        search_distance=args.search_distance,
        ckpt_every=args.ckpt_every,
        defer_analysis=not args.no_defer_analysis,
        profile_platform=args.profile_platform,
        workers=0 if args.serial else args.workers,
        max_attempts=args.max_attempts,
        retry_backoff_s=args.retry_backoff,
        stage_timeout_s=args.stage_timeout,
        gc_orphans=not args.no_gc,
        device=args.device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="artifact-driven profile/select/mark/replay/validate run")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--interval-steps", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--selector", default="kmeans",
                    choices=("random", "kmeans", "systematic"))
    ap.add_argument("--n-samples", type=int, default=6,
                    help="sample count for random/systematic selectors")
    ap.add_argument("--selector-seed", type=int, default=0)
    ap.add_argument("--fixed-k", type=int, default=0,
                    help="k-means: skip the silhouette sweep, use this k")
    ap.add_argument("--platforms", default="f32,bf16",
                    help="comma-separated platform tokens "
                         "(f32, bf16, f32-ref, bf16-chunk16, ...)")
    ap.add_argument("--profile-platform",
                    help="platform to profile on (default: first)")
    ap.add_argument("--warmup-intervals", type=int, default=1)
    ap.add_argument("--search-distance", type=float, default=0.0,
                    help="low-overhead marker search distance (UoW)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--no-defer-analysis", action="store_true",
                    help="legacy per-step interval analysis instead of the "
                         "deferred vectorized batch path")
    ap.add_argument("--workers", type=int, default=0,
                    help="DAG scheduler worker threads: ready stages run "
                         "concurrently and profiling shards across this "
                         "many analysis threads (0/1 = serial; artifact "
                         "digests are identical either way)")
    ap.add_argument("--serial", action="store_true",
                    help="force the serial stage loop (same as --workers 0)")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="stage attempts before a transient failure is "
                         "fatal (exponential backoff, deterministic jitter)")
    ap.add_argument("--retry-backoff", type=float, default=0.05,
                    metavar="S", help="base retry backoff seconds")
    ap.add_argument("--stage-timeout", type=float, default=None,
                    metavar="S", help="per-attempt stage wall-clock budget "
                    "(breach raises StageTimeout and retries)")
    ap.add_argument("--no-gc", action="store_true",
                    help="keep orphaned uncommitted artifact dirs instead "
                         "of gc'ing them at run start (use when other "
                         "pipelines share this store concurrently)")
    ap.add_argument("--faults", metavar="SPEC",
                    help="fault-injection spec (see docs/robustness.md), "
                         "e.g. 'raise:stage=profile,p=0.3;kill:n=1'; "
                         "defaults to $REPRO_FAULTS")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="deterministic seed for --faults decisions")
    ap.add_argument("--store",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro-artifacts"),
                    help="content-addressed artifact store root")
    ap.add_argument("--manifest-out",
                    help="also write the run manifest JSON to this path")
    ap.add_argument("--trace", metavar="DIR",
                    help="trace the run: write Chrome-trace trace.json, "
                         "raw trace.jsonl and metrics.json under DIR")
    ap.add_argument("--report", action="store_true",
                    help="print the human metrics table after the run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    from repro_torch import obs
    obs.log.setup()
    if args.trace:
        obs.configure(trace=True, trace_dir=args.trace)
    else:
        obs.configure_from_env()

    from repro_torch.faults import FaultInjector
    from repro_torch.pipeline import Pipeline

    if args.faults:
        injector = FaultInjector.from_spec(args.faults, seed=args.fault_seed)
    else:
        injector = FaultInjector.from_env()
    if injector is not None:
        obs.log.kv("fault_injection_enabled", logger="launch.pipeline",
                   rules=len(injector.rules), seed=injector.seed)

    manifest = Pipeline(build_config(args), args.store,
                        fault_injector=injector).run()
    if args.trace:
        tr = obs.tracer()
        trace_json = tr.write_chrome(os.path.join(args.trace, "trace.json"))
        obs.metrics().write_json(os.path.join(args.trace, "metrics.json"))
        tr.close()
        manifest["obs"]["trace_json"] = trace_json
        obs.log.kv("trace_written", logger="launch.pipeline",
                   path=trace_json, events=len(tr.events()))
    out = json.dumps(manifest, indent=1, default=str)
    print(out)
    if args.manifest_out:
        with open(args.manifest_out, "w") as f:
            f.write(out)
        obs.log.kv("manifest_written", logger="launch.pipeline",
                   path=args.manifest_out)
    if args.report:
        print(obs.metrics().report())
    return manifest


if __name__ == "__main__":
    main()
