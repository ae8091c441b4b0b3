"""Find a serving cell's capacity once, by a sweep of offered rates on the
card (the benchmark's runs never search; each cell's mix fixes its rate):

    python3 portbench/sweep.py --workload NAME --seed N --seconds S \
        --rates 1.0,2.0,3.0

For each rate the cell's engine is reset and driven by the mix's open loop,
rate replaced, for the pre-roll and ``--seconds``; one JSON line a rate says
what was offered, what completed, and what waited at the close.  A rate the
engine sustains leaves no growing backlog.
"""
import json
import sys

from run import _environment

_environment()

import argparse  # noqa: E402

import torch  # noqa: E402

from portbench.harness import program, spec, traffic  # noqa: E402
from portbench.harness.serve import OpenLoop  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from repro_torch.serve.engine import ServeEngine
    cell = spec.load(args.workload)
    fam, c, t = cell.family(), cell.config, dict(cell.traffic)
    device = torch.device("cuda", 0)
    params = fam.init_params(c, torch.Generator(device=device).manual_seed(
        args.seed), device, getattr(torch, c["dtype"]))
    eng = ServeEngine(program.arch_config(cell), batch=t["batch"],
                      max_seq=t["max_seq"], prefill_len=t["prompt_len"],
                      seed=args.seed, instrument=True, device=device)
    # every kernel built and every shape run once before the first rate
    from repro_torch.serve.engine import Request
    eng.submit(Request(-1, traffic.schedule(t, args.seed, fam.dims(c)["V"],
                                            1)[0].prompt, 2))
    while eng.step(params):
        pass
    for rate in [float(r) for r in args.rates.split(",")]:
        t["rate_per_s"] = rate
        eng.cache = eng.pre_cache = None      # never two caches at once
        torch.cuda.empty_cache()
        eng.reset()
        arr = traffic.schedule(t, args.seed, fam.dims(c)["V"],
                               traffic.arrivals_needed(t, args.seconds))
        loop = OpenLoop(eng, params, arr, t["prompt_len"], fam, c)
        loop.run_until(t["preroll_s"])
        t0, e0 = loop.now(), loop.emitted()
        w0, a0, k0 = len(loop.waiting), len(loop.active), len(eng.kinds_log)
        loop.run_until(t0 + args.seconds)
        t1 = loop.now()
        done = [r for r in loop.submitted
                if r.done_s is not None and t0 <= r.done_s <= t1]
        ttft = [1e3 * (r.first_s - r.due_s) for r in loop.submitted
                if r.first_s is not None and t0 <= r.first_s <= t1]
        tpot = [1e3 * (r.done_s - r.first_s) / (len(r.output) - 1)
                for r in done]
        print(json.dumps({
            "rate_per_s": rate, "window_s": t1 - t0,
            "offered_per_s": sum(1 for r in loop.submitted
                                 if t0 <= r.due_s <= t1) / (t1 - t0),
            "completed_per_s": len(done) / (t1 - t0),
            "tokens_per_s": (loop.emitted() - e0) / (t1 - t0),
            "waiting_at_open": w0, "waiting_at_close": len(loop.waiting),
            "active_at_open": a0,
            "prefills": eng.kinds_log[k0:].count("prefill"),
            "decodes": eng.kinds_log[k0:].count("decode"),
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            "active_at_close": len(loop.active),
            "ttft_p50_ms": program.percentile(ttft, 50),
            "ttft_p95_ms": program.percentile(ttft, 95),
            "tpot_p50_ms": program.percentile(tpot, 50),
            "tpot_p95_ms": program.percentile(tpot, 95)}), flush=True)
        del loop
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
