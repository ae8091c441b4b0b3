"""Serving cells: the program's ``ServeEngine`` with its profile on, under
an open loop, then its ``profile()`` finalize, then the check.

Requests arrive on the mix's schedule from a pre-roll of ``preroll_s`` on;
the window opens when the pre-roll ends and lasts ``--seconds``.  The loop
calls ``ServeEngine.step`` whenever there is work and sleeps to the next
arrival when there is none.  A request's time to first token runs from when
it was due to the step that gave its first token; its time per output token
from that step to the step that finished it, over its tokens after the
first.  Only requests whose first token (for TTFT) or whose end (for TPOT)
came in the window are counted; the tokens emitted in the window are divided
by the window plus the finalize, which the user waits for too.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from portbench.harness import program, traffic
from portbench.harness.trace import traced_slice


class OpenLoop:
    """The arrivals of a schedule fed to the engine, with the benchmark's
    own record of every request (due, first token, end)."""

    def __init__(self, eng, params, arrivals, prompt_len: int, fam, config):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.eng, self.params, self.arrivals = eng, params, arrivals
        self.prompt_len, self.fam, self.config = prompt_len, fam, config
        self.batch = eng.batch
        self.next = 0
        self.waiting: List = []           # submitted, no token yet
        self.active: List = []            # first token given, not finished
        self.submitted: List = []
        self.n_done = len(eng.done)
        self.base = time.perf_counter()
        self.flops = 0.0
        self.log = None                   # the traced slice's steps

    # the loop's clock, which a test may replace: seconds since the
    # schedule's start, and an idle wait until a time on it
    def now(self) -> float:
        return time.perf_counter() - self.base

    def wait_until(self, t: float) -> None:
        time.sleep(max(0.0, t - self.now()))

    def _submit_due(self, now: float) -> None:
        while (self.next < len(self.arrivals)
               and self.arrivals[self.next].due_s <= now):
            a = self.arrivals[self.next]
            r = self.Request(a.index, a.prompt, a.max_new_tokens)
            r.due_s, r.first_s, r.done_s = a.due_s, None, None
            self.eng.submit(r)
            self.waiting.append(r)
            self.submitted.append(r)
            self.next += 1

    def step(self) -> bool:
        """One engine iteration, booked; False when the engine was idle."""
        positions = [self.prompt_len + len(r.output) - 1 for r in self.active]
        if not self.eng.step(self.params):
            return False
        now = self.now()
        first = [r for r in self.waiting if r.output is not None]
        if first:
            for r in first:
                r.first_s = now
                self.waiting.remove(r)
                self.active.append(r)
            self.flops += self.fam.prefill_flops(self.config, self.prompt_len)
        else:
            self.flops += self.fam.decode_flops(self.config, positions)
        if self.log is not None:
            self.log.append(("prefill", None) if first
                            else ("decode", positions))
        for r in self.eng.done[self.n_done:]:
            r.done_s = now
            self.active.remove(r)
        self.n_done = len(self.eng.done)
        return True

    def run_until(self, t_end: float) -> None:
        while True:
            now = self.now()
            if now >= t_end:
                return
            self._submit_due(now)
            if not self.step():
                nxt = (self.arrivals[self.next].due_s
                       if self.next < len(self.arrivals) else t_end)
                self.wait_until(min(nxt, t_end))

    def run_iters(self, n: int) -> None:
        """``n`` engine iterations on the schedule (the program's own
        ``engine.prefill|decode`` spans label them in a trace); the idle
        waits labelled ``harness.idle_wait``."""
        done = 0
        while done < n:
            self._submit_due(self.now())
            if self.step():
                done += 1
            elif self.next < len(self.arrivals):
                with record_function("harness.idle_wait"):
                    self.wait_until(self.arrivals[self.next].due_s)
            else:
                return

    def emitted(self) -> int:
        return sum(len(r.output or ()) for r in self.submitted)


WINDOW_COUNTERS = ("serve.prefill_iters", "serve.decode_iters", "moe.entries",
                   "moe.slots")


def window_counters(eng) -> Dict[str, float]:
    """The program's counters that the window's readers difference, and the
    engine's iterations by kind."""
    out = {name: program.counter(name) for name in WINDOW_COUNTERS}
    out["prefills"] = eng.kinds_log.count("prefill")
    out["decodes"] = eng.kinds_log.count("decode")
    return out


def run(cell, args, device: torch.device, t_start: float) -> Dict:
    from repro_torch.serve.engine import ServeEngine
    fam, c, t = cell.family(), cell.config, cell.traffic
    cfg = program.arch_config(cell)
    marks = [time.perf_counter()]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = fam.init_params(c, gen, device, getattr(torch, c["dtype"]))
    program.sync(device)
    marks.append(time.perf_counter())
    eng = ServeEngine(cfg, batch=t["batch"], max_seq=t["max_seq"],
                      prefill_len=t["prompt_len"], seed=args.seed,
                      temperature=0.0, instrument=True, device=device)
    arrivals = traffic.schedule(t, args.seed, fam.dims(c)["V"],
                                traffic.arrivals_needed(t, args.seconds))
    # every kernel built and every shape run once before the schedule starts
    from repro_torch.serve.engine import Request
    eng.submit(Request(-1, arrivals[0].prompt, 2))
    while eng.step(params):
        pass
    program.sync(device)
    marks.append(time.perf_counter())
    loop = OpenLoop(eng, params, arrivals, t["prompt_len"], fam, c)

    # pre-roll: every shape warmed up, the load in its steady state
    loop.run_until(t["preroll_s"])
    program.sync(device)
    t0 = loop.now()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    at_open = window_counters(eng)
    e0, loop.flops = loop.emitted(), 0.0
    loop.run_until(t0 + args.seconds)
    program.sync(device)
    t1 = loop.now()
    window_s = t1 - t0
    backlog = len(loop.waiting)
    tokens = loop.emitted() - e0
    inside = {k: v - at_open[k] for k, v in window_counters(eng).items()}
    iters = inside["serve.prefill_iters"] + inside["serve.decode_iters"]
    flops = loop.flops
    f0 = time.perf_counter()
    prof = eng.profile()
    finalize_s = time.perf_counter() - f0
    steps_missing = abs(prof.n_steps - eng.iterations)

    summary, slice_steps = None, []
    if args.trace:
        loop.log = slice_steps
        with traced_slice(device.type == "cuda") as ts:
            loop.run_iters(t["trace_iters"])
        summary = ts["summary"]
        loop.log = None
    program.sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    ttft = [1e3 * (r.first_s - r.due_s) for r in loop.submitted
            if r.first_s is not None and t0 <= r.first_s <= t1]
    finished = [r for r in loop.submitted
                if r.done_s is not None and t0 <= r.done_s <= t1]
    tpot = [1e3 * (r.done_s - r.first_s) / (len(r.output) - 1)
            for r in finished if len(r.output) > 1]
    attempted = sum(1 for r in loop.submitted if t0 <= r.due_s <= t1)
    del loop, eng, prof
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the program's state is freed
    from portbench.harness import check
    sample = check.serve_sample(finished, t["check_requests"], args.seed)
    checks = {**check.served_gaps(fam, c, params, sample, t["prompt_len"],
                                  device),
              "profile_steps_missing": float(steps_missing)}
    control = {}
    if args.control:
        control = check.served_gaps(fam, c, params, sample, t["prompt_len"],
                                    device, control="fp8")

    return {
        "e2e": {"setup_s": setup_s,
                "serve_tokens_per_s": tokens / (window_s + finalize_s)},
        "run": {"window_s": window_s, "finalize_s": finalize_s,
                "iters": iters, "flops": flops, "trace": summary,
                "slice_steps": slice_steps, "family": fam, "config": c,
                "prompt_len": t["prompt_len"], "tokens": tokens,
                "moe_entries": inside["moe.entries"],
                "moe_slots": inside["moe.slots"],
                "tpot_p95_ms": program.percentile(tpot, 95)},
        "checks": checks, "control": control,
        "attempted": attempted, "failed": 0,
        "memory_peak_bytes": int(peak),
        "info": {"setup_parts_s": dict(zip(
                     ("imports", "weights", "engine_and_warmup", "preroll"),
                     [b - a for a, b in zip([t_start] + marks, marks)])),
                 "requests_due_in_window": attempted,
                 "ttft_samples": len(ttft), "tpot_samples": len(tpot),
                 "ttft_p50_p90_p95_ms": [program.percentile(ttft, q)
                                         for q in (50, 90, 95)],
                 "tpot_p50_p90_p95_ms": [program.percentile(tpot, q)
                                         for q in (50, 90, 95)],
                 "tokens_in_window": tokens, "window_s": window_s,
                 "prefills_in_window": inside["prefills"],
                 "decodes_in_window": inside["decodes"],
                 "finalize_s": finalize_s, "engine_iters": iters,
                 "compared_requests": len(sample),
                 "compared_tokens": sum(len(r.output) for r in sample),
                 "waiting_at_close": backlog},
    }
