#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py            # every phase; needs one card

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card (a sweep of small shapes and the
serving path's full-width shapes, timed), serves a handful of requests on
full-width qwen3-1.7b (bf16, random weights from a seed) through the port's
``ServeEngine``, checks by the launch counters that prefill went through the
flash-attention kernel and every decode step through the flash-decode kernel,
holds the kernel path against the plain path on the card, and builds the
interval profile of the run.

Every phase prints one JSON object on a line of its own.  The line before the
last is ``{"kernels": [...]}`` (per kernel: launches on the serving path,
error, time, the plain version's time, one library call's time as a yardstick
that the port itself never calls, and the least time the card could take).
The last line is ``{"ok": true, "device": {...}}``.  Any failing phase raises
and the run exits non-zero; with no CUDA device it exits non-zero at once.

``--phases device,build,kernels`` runs a subset while developing (the last
line is then not printed); the extra phase ``trace`` (after ``serve``) breaks
a decode step and a prefill down by kernel with ``torch.profiler``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

TOL = {torch.float32: 1e-4,    # sums run in another order than the plain version's
       torch.bfloat16: 2e-2}   # one bf16 rounding of an O(1) output

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:77",
    "flash_decode": "src/repro/kernels/flash_decode.py:70",
}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, *, warmup: int = 3, reps: int = 7, inner: int = 10) -> float:
    """Device time of one call: median over `reps` of the mean of `inner`
    back-to-back calls between two CUDA events, after warm-up.

    The host enqueues small kernels more slowly than the card runs them, so
    a plain event pair would time the host.  Each repetition therefore first
    parks the stream on a spin kernel long enough for the host to enqueue
    all `inner` calls behind it; the events then bracket device work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    spin_cycles = int((2.0 * host_s + 2e-3) * clock_hz)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit("device", name_and_power_limit=line, torch=torch.__version__,
         cuda=torch.version.cuda, **dev)
    return dev


def phase_build(ptxas_out: str) -> None:
    from repro_torch.kernels import build
    build.load(verbose=bool(ptxas_out))
    if ptxas_out:
        os.makedirs(os.path.dirname(os.path.abspath(ptxas_out)), exist_ok=True)
        with open(ptxas_out, "w") as f:
            f.write(str(build.info.get("compiler_output", "")))
    emit("build", seconds=build.info["seconds"], library=build.info["path"],
         cached=build.info["cached"], sources=build.info["sources"])


def _randn(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype).contiguous()


def _check(name, got, want, dtype, case, worst):
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if err > TOL[dtype]:
        raise AssertionError(f"{name} {case}: max abs error {err} > "
                             f"{TOL[dtype]}")
    key = str(dtype).split(".")[-1]
    worst[key] = max(worst.get(key, 0.0), err)


def sweep_flash_attention(gen) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cases = []
    for shape in [(1, 64, 2, 1, 16), (2, 96, 4, 2, 32), (1, 128, 8, 8, 64),
                  (2, 40, 6, 2, 16), (1, 200, 4, 2, 128), (1, 100, 4, 2, 256),
                  (2, 333, 10, 2, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                cases.append((shape, dtype, causal, None, 0.0, 1.0))
    for window in (8, 24, 100, 0, -1):
        for causal in (True, False):
            cases.append(((2, 64, 4, 2, 16), torch.float32, causal, window,
                          0.0, 1.0))
            cases.append(((1, 300, 4, 2, 128), torch.bfloat16, causal, window,
                          0.0, 1.0))
    cases.append(((1, 32, 2, 2, 16), torch.float32, True, None, 20.0, 4.0))
    cases.append(((1, 150, 4, 4, 64), torch.float32, True, 40, 20.0, 4.0))
    worst: dict = {}
    for (b, s, h, kv, hd), dtype, causal, window, cap, scale in cases:
        q = _randn(gen, (b, s, h, hd), dtype, scale)
        k = _randn(gen, (b, s, kv, hd), dtype, scale)
        v = _randn(gen, (b, s, kv, hd), dtype)
        kw = dict(group=h // kv, causal=causal, window=window, cap=cap)
        _check("flash_attention", flash_attention(q, k, v, **kw),
               flash_attention_plain(q, k, v, **kw), dtype,
               ((b, s, h, kv, hd), str(dtype), kw), worst)
    return {"cases": len(cases), "max_abs_err": worst}


def sweep_flash_decode(gen) -> dict:
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    cases = []
    for shape in [(2, 96, 4, 2, 32), (3, 50, 8, 4, 16), (2, 700, 10, 2, 128),
                  (1, 1000, 4, 2, 256), (3, 130, 4, 4, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((shape, dtype, "random", None, 0.0))
    for window, cap in [(8, 0.0), (-1, 20.0), (24, 20.0), (0, 0.0), (300, 0.0)]:
        cases.append(((3, 50, 8, 4, 16), torch.float32, [50, 7, 30], window, cap))
        cases.append(((3, 900, 4, 2, 128), torch.bfloat16, [900, 333, 1],
                      window, cap))
    # lengths beyond the cache (an idle slot keeps counting) and a row of 0
    cases.append(((3, 50, 8, 4, 16), torch.float32, [53, 50, 1], None, 0.0))
    cases.append(((3, 64, 8, 4, 16), torch.float32, [80, 0, 64], 8, 0.0))
    cases.append(((2, 900, 4, 2, 128), torch.bfloat16, [1000, 905], 16, 0.0))
    worst: dict = {}
    for (b, s, h, kv, hd), dtype, lens, window, cap in cases:
        q = _randn(gen, (b, 1, h, hd), dtype)
        k = _randn(gen, (b, s, kv, hd), dtype)
        v = _randn(gen, (b, s, kv, hd), dtype)
        if lens == "random":
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device="cuda", dtype=torch.int32)
        else:
            lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        kw = dict(group=h // kv, window=window, cap=cap)
        _check("flash_decode", flash_decode(q, k, v, lengths, **kw),
               flash_decode_plain(q, k, v, lengths, **kw), dtype,
               ((b, s, h, kv, hd), str(dtype), lengths.tolist(), kw), worst)
    return {"cases": len(cases), "max_abs_err": worst}


def _bound(n_bytes: float, flops: float, dtype):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def full_width_flash_attention(gen, cfg, prefill_len: int) -> dict:
    """K1 at the serving path's prefill shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    a = cfg.attn
    b, s, h, kv, hd = 1, prefill_len, a.n_heads, a.n_kv_heads, a.head_dim
    dtype = torch.bfloat16
    q = _randn(gen, (b, s, h, hd), dtype)
    k = _randn(gen, (b, s, kv, hd), dtype)
    v = _randn(gen, (b, s, kv, hd), dtype)
    kw = dict(group=h // kv, causal=True, window=-1, cap=a.softcap)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    worst: dict = {}
    _check("flash_attention", got, want, dtype, "full width", worst)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B,H,S,hd] views
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()

    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
    # causal: row i sees i + 1 keys; two products of 2*hd flops per pair
    flops = 4.0 * hd * b * h * s * (s + 1) / 2
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    return {"shape": {"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
                      "dtype": "bfloat16"},
            "max_abs_err": worst["bfloat16"], "limit": TOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": n_bytes, "flops": flops}


def full_width_flash_decode(gen, cfg, batch: int, max_seq: int,
                            prefill_len: int, n_layers: int) -> dict:
    """K2 at the serving path's decode shape, mixed lengths.  Timed over the
    layers of a whole stacked cache in turn, as the decode step walks them,
    so that no launch finds its cache rows in L2 from the launch before."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    a = cfg.attn
    b, s, h, kv, hd = batch, max_seq, a.n_heads, a.n_kv_heads, a.head_dim
    dtype = torch.bfloat16
    q = _randn(gen, (b, 1, h, hd), dtype)
    kc = _randn(gen, (n_layers, b, s, kv, hd), dtype)
    vc = _randn(gen, (n_layers, b, s, kv, hd), dtype)
    # lengths as a run has them: prefill_len plus a few dozen decoded tokens,
    # one row near the cache's end and one idle row that counted past it
    lens = [prefill_len + 1 + 9 * i for i in range(b)]
    lens[-1] = max_seq + 5
    if b > 2:
        lens[-2] = max_seq - 1
    lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
    kw = dict(group=h // kv, window=-1, cap=a.softcap)
    worst: dict = {}
    for layer in (0, n_layers - 1):
        _check("flash_decode", flash_decode(q, kc[layer], vc[layer], lengths, **kw),
               flash_decode_plain(q, kc[layer], vc[layer], lengths, **kw),
               dtype, "full width", worst)

    seen = torch.tensor([min(x, s) for x in lens], device="cuda")
    mask = (torch.arange(s, device="cuda")[None] < seen[:, None])[:, None, None]
    qt = q.transpose(1, 2)                                  # [B,H,1,hd]

    def lib_call(layer):
        return F.scaled_dot_product_attention(
            qt, kc[layer].transpose(1, 2), vc[layer].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    lib = lib_call(0).transpose(1, 2)
    want = flash_decode_plain(q, kc[0], vc[0], lengths, **kw)
    lib_err = (lib.float() - want.float()).abs().max().item()

    state = {"i": 0}

    def over_layers(fn):
        def call():
            state["i"] = (state["i"] + 1) % n_layers
            return fn(state["i"])
        return call
    ms = time_ms(over_layers(
        lambda l: flash_decode(q, kc[l], vc[l], lengths, **kw)), inner=n_layers)
    plain_ms = time_ms(over_layers(
        lambda l: flash_decode_plain(q, kc[l], vc[l], lengths, **kw)),
        inner=n_layers)
    library_ms = time_ms(over_layers(lib_call), inner=n_layers)
    elt = q.element_size()
    keys = sum(min(x, s) for x in lens)          # what this run's data needs
    n_bytes = elt * (2 * q.numel() + 2 * keys * kv * hd) + 4 * b
    flops = 4.0 * hd * h * keys
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    return {"shape": {"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
                      "dtype": "bfloat16", "lengths": lens},
            "max_abs_err": worst["bfloat16"], "limit": TOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": n_bytes, "flops": flops}


def phase_kernels(cfg, batch, max_seq, prefill_len) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {
        "flash_attention": {
            "sweep": sweep_flash_attention(gen),
            "full_width": full_width_flash_attention(gen, cfg, prefill_len)},
        "flash_decode": {
            "sweep": sweep_flash_decode(gen),
            "full_width": full_width_flash_decode(
                gen, cfg, batch, max_seq, prefill_len, min(cfg.n_layers, 28))},
    }
    emit("kernels", tolerance={"float32": TOL[torch.float32],
                               "bfloat16": TOL[torch.bfloat16]}, **out)
    return out


def reset_counters() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    flash_attention.launches = 0
    flash_decode.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    return {"flash_attention": flash_attention.launches,
            "flash_decode": flash_decode.launches}


def phase_serve(cfg, batch, max_seq, prefill_len, n_requests):
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeEngine, SyntheticRequests

    t0 = time.perf_counter()
    model = build_model(cfg)                               # on the card
    params = model.init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.param_count(params)

    def requests():
        gen = SyntheticRequests(cfg.vocab_size, prompt_len=prefill_len,
                                mean_new=24, seed=0)
        return [gen.request(i) for i in range(n_requests)]

    # warm-up on a throw-away engine: the first calls create the cuBLAS
    # handle and load every eager kernel, which is set-up, not serving
    warm = ServeEngine(cfg, batch=batch, max_seq=max_seq,
                       prefill_len=prefill_len, instrument=False)
    warm.run(params, requests()[:2])
    del warm

    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, batch=batch, max_seq=max_seq,
                      prefill_len=prefill_len)
    # ---- the main path: counters to 0 just before, read just after ---------
    reset_counters()
    stats = eng.run(params, requests())
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()

    prefills = eng.kinds_log.count("prefill")
    decodes = eng.kinds_log.count("decode")
    assert stats["requests"] == n_requests, stats
    assert prefills == n_requests, (prefills, n_requests)
    assert launches["flash_attention"] == prefills * cfg.n_layers, launches
    assert launches["flash_decode"] == decodes * cfg.n_layers, launches
    outputs = {r.req_id: r.output for r in eng.done}
    for out in outputs.values():
        assert len(out) >= 2 and all(0 <= t < cfg.vocab_size for t in out)
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
         init_seconds=init_s, batch=batch, max_seq=max_seq,
         prefill_len=prefill_len, stats=stats, prefills=prefills,
         decode_iterations=decodes, launches=launches,
         peak_memory_bytes=peak)

    # ---- the kernel path against the plain path, on the card ---------------
    # The same prefill and one decode step through the kernels, through their
    # plain versions (attention_impl="reference"), and through the plain
    # versions with f32 activations.  In bf16 the two paths sum in another
    # order, so some attention outputs round to the neighbouring bf16 value,
    # and the differences pass through every later layer.  The limit is what
    # bf16 itself costs on this input: the kernel path may lie no farther
    # from the plain path than the plain path lies from the f32 computation
    # (and never needs to be closer than 5e-2 on logits of size O(1)).
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    models = {"kernel": model, "plain": build_model(ref_cfg),
              "f32": build_model(dataclasses.replace(
                  ref_cfg, compute_dtype="float32"))}
    toks = torch.from_numpy(requests()[0].prompt)[None].to("cuda")
    batch_in = {"tokens": torch.cat([toks, toks.flip(1)]).long()}
    logits = {}
    for name, m in models.items():
        cache = m.init_cache(2, max_seq)
        pre = m.prefill(params, batch_in, cache)[0].float()
        tok = torch.full((2, 1), 17, dtype=torch.int32, device="cuda")
        logits[name] = {"prefill_logits": pre,
                        "decode_logits": m.decode_step(params, tok, cache)[0].float()}
        del cache
    errs = {}
    for what in ("prefill_logits", "decode_logits"):
        diff = lambda a, b: (logits[a][what] - logits[b][what]).abs().max().item()  # noqa: E731
        e = {"kernel_vs_plain": diff("kernel", "plain"),
             "kernel_vs_f32": diff("kernel", "f32"),
             "plain_vs_f32": diff("plain", "f32"),
             "logits_abs_max": logits["f32"][what].abs().max().item()}
        e["limit"] = max(5e-2, e["plain_vs_f32"])
        assert math.isfinite(e["kernel_vs_plain"]), (what, e)
        assert e["kernel_vs_plain"] <= e["limit"], (what, e)
        assert e["kernel_vs_f32"] <= 1.25 * e["plain_vs_f32"], (what, e)
        errs[what] = e
    del logits, models

    ref_eng = ServeEngine(ref_cfg, batch=batch, max_seq=max_seq,
                          prefill_len=prefill_len, instrument=False)
    ref_stats = ref_eng.run(params, requests())
    same = total = 0
    for r in ref_eng.done:
        out = outputs[r.req_id]
        total += max(len(out), len(r.output))
        same += sum(a == b for a, b in zip(out, r.output))
    emit("serve_vs_plain", logits_max_abs_err=errs,
         greedy_tokens_agree=same / max(total, 1), tokens_compared=total,
         plain_path_stats=ref_stats)
    return eng, launches, params


def phase_trace(eng, params, prefill_len: int, steps: int = 5) -> None:
    """Optional (`--phases ...,trace`): where a decode step's and a prefill's
    time goes.  Host time per call (host clock around calls that end in a
    synchronise), device-busy time (sum of kernel times from torch.profiler)
    and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model = eng.model
    tok = torch.zeros((eng.batch, 1), dtype=torch.int32, device="cuda")
    toks = torch.zeros((1, prefill_len), dtype=torch.int64, device="cuda")
    pre_cache = model.init_cache(1, eng.max_seq)

    def decode():
        eng.cache["length"].fill_(prefill_len + 40)
        model.decode_step(params, tok, eng.cache)

    def prefill():
        model.prefill(params, {"tokens": toks}, pre_cache)

    out = {}
    for name, fn in (("decode_step", decode), ("prefill", prefill)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / steps / 1e3, e.count // steps)
                for e in prof.key_averages()     # kernels, not the ops' sums
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        out[name] = {
            "host_ms": host_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:70], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}
    emit("trace", steps=steps, **out)


def phase_profile(eng) -> None:
    prof = eng.profile()
    names = prof.table.names
    assert prof.n_intervals >= 1
    assert any(n.startswith("prefill/") for n in names)
    assert any(n.startswith("decode/") for n in names)
    emit("profile", n_intervals=prof.n_intervals, blocks=list(names))


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="device,build,kernels,serve,profile")
    ap.add_argument("--ptxas", metavar="FILE", default="",
                    help="build with -Xptxas -v and write the compiler's "
                         "output (registers, spills) to FILE")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script only runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-1.7b")         # full width and depth
    batch, max_seq, prefill_len, n_requests = 8, 1024, 256, 16

    dev = phase_device()
    if "build" in phases:
        phase_build(args.ptxas)
    checks = phase_kernels(cfg, batch, max_seq, prefill_len) \
        if "kernels" in phases else None
    if "serve" not in phases:
        return 0
    eng, launches, params = phase_serve(cfg, batch, max_seq, prefill_len,
                                        n_requests)
    if "trace" in phases:
        phase_trace(eng, params, prefill_len)
    if "profile" in phases:
        phase_profile(eng)
    if checks is None:
        return 0

    kernels = []
    for name in ("flash_attention", "flash_decode"):
        fw = checks[name]["full_width"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": fw["max_abs_err"], "ms": fw["ms"],
            "plain_ms": fw["plain_ms"], "bound_ms": fw["bound_ms"],
            "bound_by": fw["bound_by"], "library_ms": fw["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
