#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py            # every phase; needs one card

Builds the CUDA kernels (K1 flash attention, K2 flash decode, K3 SSD
intra-chunk, the grouped MoE products of a decode step, latent attention's
absorbed decode) from the sources in this checkout, holds each kernel against
its plain PyTorch version on the card
(a sweep of small shapes and the serving paths' full-width shapes, timed;
gemma3-4b's at a windowed and at a global layer; the grouped MoE kernel at
the benchmark's decode rows, 256 and 96, and at the path's batch, beside the
whole MoE layer on the buffer path it replaces, and an engine decode step at
256 rows held to one synchronising call; deepseek-v2-lite's latent decode
and K1 at qk 192 / v 128 at its path's shapes and at its benchmark cell's, 56
rows of 16.4k to 18.4k keys and a 16k prefill), then serves 16 requests on
each of thirteen paths in turn (bf16, random
weights from seed 0) through the port's ``ServeEngine``: qwen3-1.7b, the same
with int8 weights (quantized from its weights) and an int8 KV cache
(``qwen3-1.7b/int8``), the same with int4 weights (random nibbles from seed
0, two a byte; ``qwen3-1.7b/int4``), mamba2-780m, zamba2-1.2b, olmoe-1b-7b,
whisper-tiny (its encoder's K1 not causal over 1500 frames), internvl2-76b at
its published widths with 8 of its 80 layers, gemma3-4b at full depth
(prompts of 1536 tokens and a max_seq of 2048, so that every prefill and
decode step of its 29 local layers crosses their window of 1024 tokens; the
same prefill with every window removed must move the logits past the path's
limit), qwen2.5-14b at full depth (48 layers, QKV bias),
llama4-scout-17b-a16e with 4 of its 48 layers (top-1 routing and a shared
expert) and mistral-large-123b with 4 of its 88 layers (a GQA group of 12:
K2's two head blocks) and deepseek-v2-lite whole (27 layers of latent
attention, the first a dense MLP, the rest 64 routed and 2 shared experts);
each cut is named in the path's ``reduced``. For each
path it checks, by the kernels' device events under torch.profiler and by
the wrappers' launch counters, that every prefill went through the
kernels of its layers (K1 per attention layer, K3 per Mamba2 layer) and every
decode step through K2 per attention layer, or the latent decode per latent
attention layer (and the grouped MoE kernel per MoE layer), that every
decode step but the first two (the warm-up and the capture) replayed the
step's CUDA graph and that the greedy tokens are those of the same path
decoding eagerly, holds the kernel
path against the
plain path on the card (in bf16 and in f32 activations; for MoE with the
share of routing decisions that differ, the plain path's experts on their
buffers, and the plain path with the grouped kernel beside it), and builds
the interval profile of
the run. Then the model-accuracy study of the paper's §V-B (``accuracy``):
for qwen3-1.7b, mamba2-780m and olmoe-1b-7b (4 of 16 layers) the ATen graph
of the loss forward against the kernels one call runs under torch.profiler,
their largest deltas, and the block labels locating K1, K3 and the products
in their blocks. Then it trains full-width qwen3-1.7b for 6 steps through the
port's ``Trainer`` (bf16, AdamW with the f32 master, the work meter in the
step, the interval profile at the end) on the chunked attention, which is how
the JAX package trains: K1, K2 and K3 must launch 0 times there, and on a
tensor that requires grad each kernel wrapper must refuse to run;
``remat="selective"`` against ``"full"`` on one state and batch (equal loss;
peak memory and step time); and olmoe-1b-7b at full width with 4 of its 16
layers (the MoE train check: the router's loss, the expert token counts and
the profile's expert columns). Then the staged nugget pipeline, through the
port's ``Pipeline`` (profile, select, mark, baseline, replay, validate):
full-width qwen3-1.7b on platforms bf16 and f32 in a fresh store (every stage
computes), a warm rerun (every stage hits, no ``Trainer`` is built), a
selector change (profile and baselines hit, the rest re-runs), full-width
mamba2-780m on bf16, and ``workers=4`` against serial at the reduced size;
K1, K2 and K3 must launch 0 times there too. Last, the distributed phase: an
NCCL process group of world size 1 and a ``(data, model)`` DeviceMesh; the
sharded train step of full-width qwen3-1.7b (DTensor parameters and optimizer
state placed by the training plan) against the plain step from the same
parameters, the int8 ``compressed_psum`` of a gradient tree, ``meter_psum``,
an elastic restore onto the mesh, ``gpipe`` at one stage, the fault-injected
training run at the reduced size, and every kernel wrapper refusing a
DTensor; the sharded step's kernels against the plain step's, by kernel name,
on a line of its own (``distributed_kernel_delta``). Then the dry-run phase:
seven cells of the dry-run's grid, each in a process of its own on fake CUDA
tensors (as rank 0 of a fake process group of the production mesh's 256 or
512 ranks), their roofline rows (priced with the H100 datasheet's figures),
and the one-card check: the train configuration, a decode step and a prefill
priced on a (1, 1) mesh of this card, whose bytes per device must equal what
the card allocates for the same trees, whose roofline bound must not exceed
the device-busy time that torch.profiler measures for the same step, and
whose predicted peak (the memory analysis: arguments plus temporaries) must
meet the allocator's requested peak over the train step and a decode step.

Every phase prints one JSON object on a line of its own.  The line before the
last is ``{"kernels": [...]}`` (per kernel: launches on the serving paths,
the train path and the pipeline paths; error, time, the plain version's time, one library
call's time as a yardstick that the port itself never calls, or null where
no single call computes the function, and the least time the card could
take, at the first path's shape, and the same at every path's shape,
``full_width``, and for K1 and K2 at one long shape, ``long``, timed and not
gated).  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase raises and the run exits
non-zero; with no CUDA device it exits non-zero at once.

``--phases device,build,kernels`` and ``--paths mamba2-780m`` (or
``--paths qwen3-1.7b,qwen3-1.7b/int8``, ``--paths gemma3-4b``) run a subset
while developing (the last two lines are then not printed); the extra phase
``trace`` (after ``serve``) breaks a decode step and a prefill of each path
down by kernel with ``torch.profiler``, and ``plans`` (after ``kernels``)
times K1, K2 and K3 with every tile choice their launch plans choose from.
``--phases device,build,accuracy`` runs the §V-B study alone,
``--phases device,train`` runs the training phase (the MoE train check
included) alone,
``--phases device,pipeline`` the pipeline phase,
``--phases device,distributed`` the distributed phase, and
``--phases device,dryrun`` the dry-run phase.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

TOL = {torch.float32: 1e-4,    # sums run in another order than the plain version's
       torch.bfloat16: 2e-2}   # one bf16 rounding of an O(1) output

# K3's y and s_chunk are not O(1), so its limit is relative to the largest
# magnitude of the plain version's output: the reference's own SSD tolerance
# (2e-4, tests/test_kernels.py), plus what rounding cum = cumsum(dt A) to f32
# costs (`ssd_limit`).  Both versions upcast the same rounded inputs and sum
# in f32, so they agree near f32 for bf16 inputs too; what differs is the
# order of the sums, the cumsum's included, and exp(cum_t - cum_s) moves by
# the cumsum's rounding, a few ulp of |cum|: eps_f32 * max|cum| relatively.
SSD_REL_TOL = 2e-4


def ssd_limit(cum) -> float:
    """K3's relative limit for inputs whose cumsum(dt A), as the plain
    version returns it, is `cum` (see SSD_REL_TOL)."""
    return SSD_REL_TOL + torch.finfo(torch.float32).eps * \
        cum.abs().max().item()


# The MoE path in f32 activations (olmoe-1b-7b), relative to the largest
# logit.  On one H100 the kernel and plain paths differ there by 1.6e-3 to
# 9.8e-3 of it in a prefill and 2.5e-4 to 2.5e-3 in a decode step (weights
# drawn on the CPU generator and on the card's): a random-weight MoE stack
# amplifies the f32 rounding as a Mamba2 stack does (see `phase_serve`),
# where qwen3-1.7b's logits move by 6e-6.  The limit lies above those runs;
# the plain path in bf16 activations is the control that must fail it
# (0.83 to 1.36 times the largest logit).
MOE_F32_REL_TOL = 3e-2

# The whole serving path in f32 activations, kernels against plain versions,
# relative to the largest logit, by family.  Every kernel takes f32 and sums
# in IEEE f32, so the two paths differ by the order of f32 sums only.  On
# one H100 that is 6.3e-6 on qwen3-1.7b, and 2.0e-2 to 2.6e-2 on mamba2-780m
# and zamba2-1.2b: a random-weight Mamba2 stack amplifies the f32 rounding
# of the SSD's cumsum (|cum| up to 1e4; 3e-4 of the first layer's output) as
# it amplifies bf16 rounding.  The limits lie above those runs; the plain
# path in bf16 activations is the control that must fail them (0.040 to
# 0.046 on qwen3-1.7b, 0.56 to 0.66 on the SSM paths), or the check could
# not tell a fault of bf16 size.  The enc-dec and VLM paths start from the
# dense limit (their stacks are dense layers; the int8 path is dense).
PATH_F32_REL_TOL = {"dense": 1e-4, "ssm": 6e-2, "hybrid": 6e-2,
                    "moe": MOE_F32_REL_TOL, "encdec": 1e-4, "vlm": 1e-4}

KERNELS = ("flash_attention", "flash_decode", "ssd_intra", "grouped_mlp",
           "mla_decode")
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:77",
    "flash_decode": "src/repro/kernels/flash_decode.py:70",
    "ssd_intra": "src/repro/kernels/ssd.py:62",
    # added for the MoE decode step; the reference's experts are XLA
    # einsums over capacity buffers
    "grouped_mlp": None,
    # added for latent attention's decode step; the reference has no latent
    # attention
    "mla_decode": None,
}
SOURCES = {       # the kernel that the bf16 timings measure
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "ssd_intra": "src/repro_torch/kernels/csrc/ssd_tc.cu",
    "grouped_mlp": "src/repro_torch/kernels/csrc/moe_grouped.cu",
    "mla_decode": "src/repro_torch/kernels/csrc/mla_decode.cu",
}
SOURCES_ALL = {**{k: [v] for k, v in SOURCES.items()},
               "flash_attention": [   # entry point and the f32 kernel, bf16
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   SOURCES["flash_attention"]],
               "ssd_intra": [         # the f32 kernel, bf16
                   "src/repro_torch/kernels/csrc/ssd.cu",
                   SOURCES["ssd_intra"]]}


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
    """K1 against its plain version.  Besides the shapes of
    tests/test_kernels.py: S below 16 and S a multiple of no q tile (32, 64,
    128) and no kv tile (16, 32, 64); grids that take each plan of the bf16
    kernel (8, 4 and 2 row warps, by `attention_plan`); window edges inside
    a tile, window 0 (every key masked: the mean of V) and soft-capping, in
    both dtypes; bf16 at every head_dim; whisper-tiny's encoder shape
    (non-causal, S 1500, H = KV = 6, hd 64) in both dtypes."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for shape in [(1, 64, 2, 1, 16), (2, 96, 4, 2, 32), (1, 128, 8, 8, 64),
                  (2, 40, 6, 2, 16), (1, 200, 4, 2, 128), (1, 100, 4, 2, 256),
                  (2, 333, 10, 2, 64),
                  (1, 5, 2, 1, 64), (2, 9, 4, 2, 128), (1, 13, 2, 2, 256),
                  (1, 77, 4, 2, 16), (2, 150, 6, 3, 32)]:
        for dtype in (f32, bf16):
            for causal in (True, False):
                cases.append((shape, dtype, causal, None, 0.0, 1.0))
    # every bf16 plan: 8 row warps (one kv warp) at head_dim 64, 128 and 256,
    # 4 (two kv warps) at 64, 128, 256, 2 (four kv warps) at 128 and below
    for shape in [(4, 300, 16, 4, 64), (4, 300, 16, 8, 128),
                  (2, 1100, 8, 4, 256), (2, 400, 12, 4, 64),
                  (1, 600, 16, 8, 128), (2, 520, 8, 8, 256),
                  (1, 256, 16, 8, 128)]:
        for causal in (True, False):
            cases.append((shape, bf16, causal, None, 0.0, 1.0))
    for window in (8, 24, 100, 0, -1):
        for causal in (True, False):
            cases.append(((2, 64, 4, 2, 16), f32, causal, window, 0.0, 1.0))
            cases.append(((1, 300, 4, 2, 128), bf16, causal, window, 0.0, 1.0))
    for shape, window in [((4, 300, 16, 4, 64), 40), ((4, 300, 16, 4, 64), 0),
                          ((1, 600, 16, 8, 128), 100), ((1, 600, 16, 8, 128), 0),
                          ((1, 200, 4, 2, 256), 50), ((2, 100, 4, 2, 16), 20),
                          ((2, 9, 4, 2, 32), 3)]:
        for causal in (True, False):
            cases.append((shape, bf16, causal, window, 0.0, 1.0))
    cases.append(((1, 32, 2, 2, 16), f32, True, None, 20.0, 4.0))
    cases.append(((1, 150, 4, 4, 64), f32, True, 40, 20.0, 4.0))
    cases.append(((1, 150, 4, 4, 64), bf16, True, 40, 20.0, 4.0))
    cases.append(((1, 256, 16, 8, 128), bf16, True, None, 30.0, 4.0))
    # whisper-tiny's encoder: non-causal over 1500 frames, a ragged last tile
    # whatever the plan's tile (1500 = 23 x 64 + 28)
    for dtype in (f32, bf16):
        cases.append(((1, 1500, 6, 6, 64), dtype, False, None, 0.0, 1.0))
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
    """K2 against its plain version.  Besides the shapes of
    tests/test_kernels.py: groups 1, 2, 3, 5, 8, 12 and 16 (a group above 8
    heads takes two head blocks); lengths 1, exactly S and S + 5; lengths
    and a window edge at the chunk boundaries of `split_plan` (at B 3, KV 2,
    S 700: six chunks of 128 keys); every head_dim in both dtypes (at 16 a
    warp step covers 16 keys in bf16, at 256 an f32 lane holds two
    segments)."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for shape in [(2, 96, 4, 2, 32), (3, 50, 8, 4, 16), (2, 700, 10, 2, 128),
                  (1, 1000, 4, 2, 256), (3, 130, 4, 4, 64),
                  (2, 300, 5, 1, 128), (2, 300, 8, 1, 64), (2, 300, 24, 2, 128),
                  (2, 300, 12, 1, 64), (2, 300, 3, 1, 32), (1, 200, 16, 1, 128)]:
        for dtype in (f32, bf16):
            cases.append((shape, dtype, "random", None, 0.0))
    for window, cap in [(8, 0.0), (-1, 20.0), (24, 20.0), (0, 0.0), (300, 0.0)]:
        cases.append(((3, 50, 8, 4, 16), f32, [50, 7, 30], window, cap))
        cases.append(((3, 900, 4, 2, 128), bf16, [900, 333, 1],
                      window, cap))
    # lengths beyond the cache (an idle slot keeps counting) and a row of 0
    cases.append(((3, 50, 8, 4, 16), f32, [53, 50, 1], None, 0.0))
    cases.append(((3, 64, 8, 4, 16), f32, [80, 0, 64], 8, 0.0))
    cases.append(((2, 900, 4, 2, 128), bf16, [1000, 905], 16, 0.0))
    # lengths 1, exactly S and S + 5; chunk boundaries (chunks of 128 keys)
    cases.append(((3, 700, 4, 2, 128), bf16, [1, 700, 705], None, 0.0))
    cases.append(((3, 300, 8, 2, 64), f32, [1, 300, 305], None, 0.0))
    cases.append(((3, 700, 4, 2, 128), bf16, [127, 128, 129], None, 0.0))
    cases.append(((3, 700, 4, 2, 128), bf16, [255, 256, 641], None, 0.0))
    cases.append(((3, 700, 4, 2, 64), f32, [128, 384, 641], None, 0.0))
    cases.append(((3, 700, 4, 2, 128), bf16, [300, 640, 700], 200, 0.0))
    cases.append(((3, 700, 10, 2, 128), bf16, [129, 512, 700], 128, 20.0))
    cases.append(((3, 700, 24, 2, 128), bf16, [1, 385, 705], 256, 0.0))
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


def _window_mask(s: int, window: int, device="cuda"):
    """[S, S] bool: row i sees keys j <= i with i - j < window, the
    library's mask of a causal layer with a sliding window."""
    i = torch.arange(s, device=device)
    d = i[:, None] - i[None, :]
    return (d >= 0) & (d < window)


def _time_flash_attention(gen, b, s, h, kv, hd, cap, causal=True,
                          window=-1) -> dict:
    """K1 in bf16, causal or not, against its plain version, timed beside
    the plain version and one library call (with the same `is_causal`; with
    a ``window``, causal, the window as a boolean mask, which takes another
    of the library's backends than `is_causal` does)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plan,
                                                     flash_attention,
                                                     flash_attention_plain)
    dtype = torch.bfloat16
    q = _randn(gen, (b, s, h, hd), dtype)
    k = _randn(gen, (b, s, kv, hd), dtype)
    v = _randn(gen, (b, s, kv, hd), dtype)
    assert window < 0 or causal, "a window is timed on causal layers"
    kw = dict(group=h // kv, causal=causal, window=window, cap=cap)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    worst: dict = {}
    _check("flash_attention", got, want, dtype,
           ("timed", b, s, h, kv, hd, window), worst)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B,H,S,hd] views
    lib_kw = (dict(is_causal=causal) if window < 0 else
              dict(attn_mask=_window_mask(s, window)))

    def lib_call():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **lib_kw)
    lib = lib_call().transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()
    del got, want, lib

    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw))
    library_ms = time_ms(lib_call)
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
    # two products of 2*hd flops per (row, key) pair; causal: row i sees
    # i + 1 keys (at most `window`), else all S
    if not causal:
        pairs = s * s
    elif window < 0 or window >= s:
        pairs = s * (s + 1) / 2
    else:
        pairs = window * (window + 1) / 2 + (s - window) * window
    flops = 4.0 * hd * b * h * pairs
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    plan = attention_plan(b, s, h, hd, dtype)
    return {"shape": {"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
                      "dtype": "bfloat16", "causal": causal,
                      "window": window},
            "library_call": ("is_causal" if window < 0 else
                             "attn_mask (the window, boolean)"),
            "plan": {"bq": plan.bq, "bk": plan.bk, "warps": plan.warps,
                     "kv_warps": plan.kv_warps, "blocks": plan.blocks,
                     "smem_bytes": plan.smem_bytes},
            "max_abs_err": worst["bfloat16"], "limit": TOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": n_bytes, "flops": flops}


def full_width_flash_attention(gen, cfg, prefill_len: int,
                               causal: bool = True, window: int = -1) -> dict:
    """K1 at the serving path's prefill shape (``prefill_len`` rows; the
    enc-dec encoder's: ``n_frames`` rows, not causal) and layer window."""
    a = cfg.attn
    return _time_flash_attention(gen, 1, prefill_len, a.n_heads, a.n_kv_heads,
                                 a.head_dim, a.softcap, causal, window)


def _time_flash_decode(gen, b, s, h, kv, hd, cap, lens, n_layers,
                       window=-1) -> dict:
    """K2 in bf16 at lengths `lens` (and `window`), against its plain
    version on the first and last of `n_layers` stacked caches, timed over
    the layers in turn, as the decode step walks them, so that no launch
    finds its cache rows in L2 from the launch before."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (decode_layout, flash_decode,
                                                  flash_decode_plain,
                                                  head_blocks, split_plan)
    from repro_torch.kernels import build
    dtype = torch.bfloat16
    q = _randn(gen, (b, 1, h, hd), dtype)
    kc = _randn(gen, (n_layers, b, s, kv, hd), dtype)
    vc = _randn(gen, (n_layers, b, s, kv, hd), dtype)
    lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
    kw = dict(group=h // kv, window=window, cap=cap)
    worst: dict = {}
    for layer in (0, n_layers - 1):
        _check("flash_decode", flash_decode(q, kc[layer], vc[layer], lengths, **kw),
               flash_decode_plain(q, kc[layer], vc[layer], lengths, **kw),
               dtype, ("timed", b, s, h, kv, hd, window), worst)

    # the keys each row sees: [lo, hi), its window's lower edge to its
    # length, cut to the cache
    lo = [max(0, x - window) if window > 0 else 0 for x in lens]
    hi = [min(x, s) for x in lens]
    assert all(a < b for a, b in zip(lo, hi)), (lo, hi)
    pos = torch.arange(s, device="cuda")[None]
    mask = ((pos < torch.tensor(hi, device="cuda")[:, None])
            & (pos >= torch.tensor(lo, device="cuda")[:, None]))[:, None, None]
    qt = q.transpose(1, 2)                                  # [B,H,1,hd]

    def lib_call(layer):
        return F.scaled_dot_product_attention(
            qt, kc[layer].transpose(1, 2), vc[layer].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    lib = lib_call(0).transpose(1, 2)
    want = flash_decode_plain(q, kc[0], vc[0], lengths, **kw)
    lib_err = (lib.float() - want.float()).abs().max().item()
    del lib, want

    state = {"i": 0}

    def over_layers(fn):
        def call():
            state["i"] = (state["i"] + 1) % n_layers
            return fn(state["i"])
        return call
    kernel = over_layers(lambda l: flash_decode(q, kc[l], vc[l], lengths, **kw))
    ms = time_ms(kernel, inner=n_layers)
    plain_ms = time_ms(over_layers(
        lambda l: flash_decode_plain(q, kc[l], vc[l], lengths, **kw)),
        inner=n_layers)
    library_ms = time_ms(over_layers(lib_call), inner=n_layers)
    elt = q.element_size()
    keys = sum(b - a for a, b in zip(lo, hi))     # what this run's data needs
    n_bytes = elt * (2 * q.numel() + 2 * keys * kv * hd) + 4 * b
    flops = 4.0 * hd * h * keys
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    n_splits, chunk = split_plan(b, kv, s, build.load().rt_flash_decode_tile())
    return {"shape": {"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
                      "dtype": "bfloat16", "lengths": lens,
                      "stacked_layers": n_layers, "window": window},
            "plan": {"n_splits": n_splits, "chunk": chunk,
                     "heads_per_block": head_blocks(h // kv)[1],
                     **decode_layout(hd, dtype)},
            "max_abs_err": worst["bfloat16"], "limit": TOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": n_bytes, "flops": flops}


def full_width_flash_decode(gen, cfg, batch: int, max_seq: int,
                            prefill_len: int, n_layers: int,
                            window: int = -1) -> dict:
    """K2 at the serving path's decode shape: lengths as a run has them,
    prefill_len plus a few dozen decoded tokens, one row near the cache's end
    and one idle row that counted past it; at a layer ``window``."""
    a = cfg.attn
    lens = [prefill_len + 1 + 9 * i for i in range(batch)]
    lens[-1] = max_seq + 5
    if batch > 2:
        lens[-2] = max_seq - 1
    return _time_flash_decode(gen, batch, max_seq, a.n_heads, a.n_kv_heads,
                              a.head_dim, a.softcap, lens, n_layers, window)


def long_shapes(gen, cfg) -> dict:
    """One long shape per attention kernel at `cfg`'s widths, reported and
    not gated on time: K1 at B 1, S 4096; K2 at B 8, S 8192, every row at
    length 8192, over 4 stacked layers (268 MB of cache a layer at qwen3's
    widths, so no launch finds its rows in L2)."""
    a = cfg.attn
    out = {"flash_attention": dict(arch=cfg.name, **_time_flash_attention(
        gen, 1, 4096, a.n_heads, a.n_kv_heads, a.head_dim, a.softcap))}
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_decode"] = dict(arch=cfg.name, **_time_flash_decode(
        gen, 8, 8192, a.n_heads, a.n_kv_heads, a.head_dim, a.softcap,
        [8192] * 8, 4))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ssd_inputs(gen, b, s, nh, hp, n, dtype, rates="fast"):
    """x, B and C in the compute dtype; dt and A in f32.  `rates="fast"`:
    as a random-weight Mamba2 layer makes them, dt = softplus(N(0, 1)) and
    A = -U(1, 16) (the `A_log` init); a chunk then decays by about e^-50
    within 64 steps, so only the tiles near the diagonal show in y, only the
    last steps in s_chunk, and decay underflows to 0.  `rates="slow"`: dt
    log-uniform on [1e-3, 1e-1] (Mamba2's dt range at init) and A =
    -U(0.05, 0.5), so a chunk of 256 steps decays by about e^-3 at most and
    every (t, s) pair, every step's share of s_chunk and decay show."""
    x = _randn(gen, (b, s, nh, hp), dtype)
    u = torch.rand((b, s, nh), generator=gen, device="cuda")
    v = torch.rand((nh,), generator=gen, device="cuda")
    if rates == "fast":
        dt = torch.nn.functional.softplus(_randn(gen, (b, s, nh),
                                                 torch.float32))
        A = -(1.0 + 15.0 * v)
    else:
        dt = torch.exp(math.log(1e-3) + math.log(100.0) * u)
        A = -(0.05 + 0.45 * v)
    Bp = _randn(gen, (b, s, n), dtype)
    Cp = _randn(gen, (b, s, n), dtype)
    return x, dt.contiguous(), A, Bp, Cp


def _far_shares(args, chunk, want) -> dict:
    """How much of the plain outputs `want` the far work carries, relative
    to each output's largest magnitude: in y, the (t, s) pairs of tile pairs
    at least two 64-step tiles apart (x kept in the first tile of each chunk
    only, y read at steps 128 and later of a chunk, where only such pairs
    reach); in s_chunk, the first tile's steps; and the smallest decay.  A
    kernel that skipped or misplaced that work would be off by about these
    shares, so each must be far above the limit."""
    from repro_torch.kernels.ssd import ssd_intra_plain
    x = args[0]
    q = min(chunk, x.shape[1])
    step = torch.arange(x.shape[1], device=x.device) % q
    first = (step < 64).to(x.dtype)[None, :, None, None]
    y, s_chunk = ssd_intra_plain(x * first, *args[1:], chunk)[:2]
    late = step >= 128
    return {"y": (y[:, late].abs().max() / want[0].abs().max()).item(),
            "s_chunk": (s_chunk.abs().max() / want[1].abs().max()).item(),
            "min_decay": want[2].min().item()}


def _check_ssd(got, want, case, worst, far=None) -> None:
    """K3's four outputs against the plain version's, each within
    `ssd_limit` of its largest magnitude.  With `far` (`_far_shares` of
    slow-rate inputs), also that the far work is visible: each far share at
    least 10x the limit, and no chunk decayed below 1e-3."""
    torch.cuda.synchronize()
    limit = ssd_limit(want[3])
    worst["limit"] = max(worst.get("limit", 0.0), limit)
    if far is not None:
        if min(far["y"], far["s_chunk"]) < 10 * limit or \
                far["min_decay"] < 1e-3:
            raise AssertionError(f"ssd_intra {case}: slow-rate inputs whose "
                                 f"far work does not show: {far}")
        for key in ("y", "s_chunk", "min_decay"):
            worst[f"slow_far_{key}"] = min(worst.get(f"slow_far_{key}", 1.0),
                                           far[key])
    for name, g, w in zip(("y", "s_chunk", "decay", "cum"), got, want):
        if g.shape != w.shape:
            raise AssertionError(f"ssd_intra {case}: {name} shape "
                                 f"{tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"ssd_intra {case}: non-finite {name}")
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        if err > limit * scale:
            raise AssertionError(f"ssd_intra {case}: {name} max abs error "
                                 f"{err} > {limit} x {scale}")
        worst[name] = max(worst.get(name, 0.0), err / max(scale, 1e-30))
        worst["abs"] = max(worst.get("abs", 0.0), err)
        worst["share_of_limit"] = max(worst.get("share_of_limit", 0.0),
                                      err / max(limit * scale, 1e-30))


def _offset(t, elems: int):
    """A contiguous copy of `t` that starts `elems` elements past an
    allocation's start (so off its 16-byte alignment)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


def sweep_ssd(gen) -> dict:
    """K3 against its plain version.  The shapes of tests/test_kernels.py,
    S below the chunk, a ragged last chunk, N 4 and 128, in both dtypes, on
    fast rates and (chunk 256) slow ones; then the bf16 kernel with every
    plan it is built for (each head group of each head_dim, t tiles alone
    and paired; 5 heads, so the last group is ragged; N 12, which takes
    8-byte copies, and 128), and bf16 inputs off their 16-byte alignment,
    which take the f32 kernel."""
    from repro_torch.kernels import ssd as K
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    cases = []
    long = [(1, 512, 4, 64, 128, 256),             # S a multiple of q, N 128
            (2, 300, 5, 64, 64, 256),              # ragged last chunk
            (1, 1000, 2, 32, 128, 256)]
    for shape in [(1, 64, 2, 16, 8, 16), (2, 96, 3, 16, 8, 32),
                  (1, 80, 4, 32, 16, 32),          # tests/test_kernels.py
                  (2, 40, 3, 16, 8, 64),           # S < chunk
                  *long, (3, 7, 2, 16, 4, 16)]:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((shape, dtype, "fast", None))
    for shape in long:                             # every tile pair shows
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((shape, dtype, "slow", None))
    for hp, groups in K.TC_HEADS.items():          # every bf16 plan
        for g in groups:
            for pair in (False, True):
                n = 128 if pair else 12
                cases.append(((2, 300, 5, hp, n, 256), torch.bfloat16,
                              "slow" if pair else "fast", (g, pair)))
    for shape in [(2, 300, 5, 64, 64, 256), (1, 7, 2, 16, 4, 16)]:
        cases.append((shape, torch.bfloat16, "fast", "offset"))
    worst: dict = {}
    for (b, s, nh, hp, n, chunk), dtype, rates, how in cases:
        args = _ssd_inputs(gen, b, s, nh, hp, n, dtype, rates)
        if how == "offset":
            args = (_offset(args[0], 1), args[1], args[2],
                    _offset(args[3], 1), _offset(args[4], 3))
            assert K._tc_vec(args[0], args[3], args[4]) == 0
        want = ssd_intra_plain(*args, chunk)
        far = _far_shares(args, chunk, want) if rates == "slow" else None
        if isinstance(how, tuple):
            plan = K.ssd_plan(b, s, nh, hp, n, chunk, dtype,
                              heads_per_block=how[0], pair=how[1])
            got = K.launch_with_plan(*args, chunk, plan)
        else:
            got = ssd_intra(*args, chunk)
        _check_ssd(got, want,
                   ((b, s, nh, hp, n, chunk), str(dtype), rates, how), worst,
                   far)
    return {"cases": len(cases), "max_rel_err": worst}


def ssd_work(b, s, nh, hp, n, chunk, elt):
    """(bytes, flops) that the function needs for these inputs: each input
    read once, each output written once; the products over the steps at or
    below the diagonal, C B^T once per (batch, chunk)."""
    q = min(chunk, s)
    nc = -(-s // q)
    n_bytes = (elt * (b * s * nh * hp + 2 * b * s * n) + 4 * (b * s * nh + nh)
               + 4 * (b * s * nh * hp + b * nc * nh * hp * n + b * nc * nh
                      + b * nc * q * nh))
    pairs = 0                                  # (t, s) pairs with s <= t
    for c in range(nc):
        m = min(q, s - c * q)
        pairs += m * (m + 1) // 2
    flops = b * (2.0 * n * pairs                       # C B^T
                 + nh * (pairs * (2.0 * hp + 2)        # L o CB, then times x dt
                         + 2.0 * s * hp * n))          # s_chunk
    return n_bytes, flops


def full_width_ssd(gen, cfg, prefill_len: int) -> dict:
    """K3 at a prefill's shape of `cfg` (one row, bf16)."""
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    from repro_torch.models.ssm import ssm_dims
    _, nh = ssm_dims(cfg)
    b, s, hp, n, chunk = 1, prefill_len, cfg.ssm.head_dim, cfg.ssm.d_state, \
        cfg.ssm.chunk
    dtype = torch.bfloat16
    slow: dict = {}               # the same shape at slow rates, not timed
    sargs = _ssd_inputs(gen, b, s, nh, hp, n, dtype, "slow")
    want = ssd_intra_plain(*sargs, chunk)
    _check_ssd(ssd_intra(*sargs, chunk), want, (cfg.name, "full width, slow"),
               slow, _far_shares(sargs, chunk, want))
    del sargs, want
    args = _ssd_inputs(gen, b, s, nh, hp, n, dtype)
    worst: dict = {}
    want = ssd_intra_plain(*args, chunk)
    _check_ssd(ssd_intra(*args, chunk), want, (cfg.name, "full width"), worst)
    limit = worst["limit"]
    ms = time_ms(lambda: ssd_intra(*args, chunk))
    plain_ms = time_ms(lambda: ssd_intra_plain(*args, chunk))
    n_bytes, flops = ssd_work(b, s, nh, hp, n, chunk, 2)
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    return {"arch": cfg.name,
            "shape": {"B": b, "S": s, "nh": nh, "hp": hp, "N": n,
                      "chunk": chunk, "dtype": "bfloat16"},
            "max_rel_err": worst, "max_abs_err": worst["abs"],
            "limit": limit, "slow_rates": slow,
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,   # no single PyTorch call computes it
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": n_bytes, "flops": flops}


# The grouped MoE kernel against its plain version.  Both sum in f32 and
# round h and the output to bf16 at the same places, so they differ where a
# sum in another order lands on the other side of a rounding: at most one
# bf16 unit of an output, and a flipped h moves an output by far less.  The
# limit is one bf16 unit (eps 2^-7) of the largest output.
GROUPED_REL_TOL = torch.finfo(torch.bfloat16).eps
# Rows of the benchmark's MoE decode steps: the chat cell's 256 and the long
# prompt cell's 96 (portbench/traffic/); each MoE path is timed at these and
# at its own batch.
MOE_DECODE_ROWS = (256, 96)


def _grouped_inputs(gen, t, e, k, d, fe, route="router"):
    """(x, wi, wg, wo, order, counts, ends) for `grouped_mlp`: bf16 x of
    std 1 and weights of std 1/sqrt(fan-in), and a route: the top-k of
    random logits ("router"), every token to experts 0..k-1 ("same"), or,
    for k 1, a list of each expert's count, in a random order."""
    from repro_torch.kernels.moe_grouped import sort_entries
    from repro_torch.models.moe import expert_counts
    dtype = torch.bfloat16
    x = _randn(gen, (t, d), dtype)
    wi = _randn(gen, (e, d, fe), dtype, d ** -0.5)
    wg = _randn(gen, (e, d, fe), dtype, d ** -0.5)
    wo = _randn(gen, (e, fe, d), dtype, fe ** -0.5)
    if route == "router":
        logits = torch.randn((t, e), generator=gen, device="cuda")
        flat = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    elif route == "same":
        flat = torch.arange(k, device="cuda").repeat(t)
    else:
        assert k == 1 and sum(route) == t, (k, route, t)
        flat = torch.repeat_interleave(torch.arange(e, device="cuda"),
                                       torch.tensor(route, device="cuda"))
        flat = flat[torch.randperm(t, generator=gen, device="cuda")]
    counts = expert_counts(flat, e)
    order, ends = sort_entries(flat, counts)
    return x, wi, wg, wo, order, counts, ends


def _check_grouped(got, want, case, worst) -> None:
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"grouped_mlp {case}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > GROUPED_REL_TOL * scale:
        raise AssertionError(f"grouped_mlp {case}: max abs error {err} > "
                             f"{GROUPED_REL_TOL} x {scale}")
    worst["abs"] = max(worst.get("abs", 0.0), err)
    worst["rel"] = max(worst.get("rel", 0.0), err / scale)


def sweep_grouped_mlp(gen) -> dict:
    """The grouped MoE kernel against its plain version at small shapes:
    one token, every expert taking every token, experts with no entry, with
    1, 15, 16, 17, 63, 64, 65 and 80 entries (one to two chunks of 64) and
    with 200 (four), widths of one to four tiles."""
    from repro_torch.kernels.moe_grouped import grouped_mlp, grouped_mlp_plain
    cases = [  # (tokens, experts, top_k, d, d_expert, route)
        (1, 4, 1, 64, 64, "router"),
        (3, 4, 2, 128, 64, "router"),
        (7, 8, 8, 64, 128, "router"),
        (64, 64, 8, 256, 128, "router"),
        (200, 4, 2, 64, 192, "same"),
        (256, 8, 1, 128, 64, [0, 1, 15, 16, 17, 63, 64, 80]),
        (130, 3, 1, 64, 64, [0, 65, 65]),
    ]
    worst: dict = {}
    for t, e, k, d, fe, route in cases:
        args = _grouped_inputs(gen, t, e, k, d, fe, route)
        _check_grouped(grouped_mlp(*args, top_k=k),
                       grouped_mlp_plain(*args, top_k=k),
                       (t, e, k, d, fe, route), worst)
    return {"cases": len(cases), "max_err": worst}


@contextlib.contextmanager
def buffer_path():
    """`moe_mlp` on its buffer path whatever the input (the grouped route
    closed)."""
    from repro_torch.models import moe
    real = moe.grouped_route
    moe.grouped_route = lambda *a, **kw: False
    try:
        yield
    finally:
        moe.grouped_route = real


def _grouped_library(args, k):
    """One library yardstick, never called by the port: the three products
    as `torch._grouped_mm` calls on the tokens already gathered in sorted
    order (the gather not timed), the gate in bf16 between them.  (ms, max
    error relative to the plain version's largest output), or (None, why)."""
    import torch.nn.functional as F
    from repro_torch.kernels.moe_grouped import grouped_mlp_plain
    x, wi, wg, wo, order, counts, ends = args
    mm = getattr(torch, "_grouped_mm", None)
    if mm is None:
        return None, "torch._grouped_mm is absent"
    xs = x[order // k]

    def call():
        a = mm(xs, wi, offs=ends)
        return mm(F.silu(a) * mm(xs, wg, offs=ends), wo, offs=ends)
    try:
        got = call()
    except (RuntimeError, TypeError, ValueError) as err:
        return None, f"{type(err).__name__}: {str(err)[:200]}"
    want = grouped_mlp_plain(*args, top_k=k)[order].float()
    rel = ((got.float() - want).abs().max() / want.abs().max()).item()
    return time_ms(call), rel


def full_width_grouped_mlp(gen, cfg, t: int) -> dict:
    """The grouped MoE kernel at a decode step of ``t`` rows at `cfg`'s
    widths, routed by random logits: against its plain version, timed beside
    the plain version, the library yardstick and its bound (the routed
    experts' weights, the tokens and the outputs, each once); then the whole
    MoE layer (`moe_mlp`, weights from the model's init) on the grouped path
    against the buffer path it replaces, timed, with their largest
    difference relative to the largest output (bf16 rounds at other places
    on the buffer path: reported, not held)."""
    from repro_torch.kernels.moe_grouped import grouped_mlp, grouped_mlp_plain
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    m = cfg.moe
    d, fe, e, k = cfg.d_model, m.d_expert, m.n_experts, m.top_k
    dtype = torch.bfloat16
    args = _grouped_inputs(gen, t, e, k, d, fe)
    worst: dict = {}
    _check_grouped(grouped_mlp(*args, top_k=k),
                   grouped_mlp_plain(*args, top_k=k), (cfg.name, t), worst)
    ms = time_ms(lambda: grouped_mlp(*args, top_k=k))
    plain_ms = time_ms(lambda: grouped_mlp_plain(*args, top_k=k),
                       warmup=1, reps=3, inner=2)
    library_ms, library_err = _grouped_library(args, k)
    n = t * k
    active = int((args[5] > 0).sum())
    n_bytes = (2 * (t * d + active * 3 * d * fe + n * d)   # x, weights, out
               + 8 * n + 8 * e)                           # order, counts, ends
    flops = 2.0 * 3 * n * d * fe
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    del args
    params = L.init_tree(gen, M.moe_specs(cfg), dtype, "cuda")
    x = _randn(gen, (t, 1, d), dtype)
    with torch.no_grad():
        grouped_y = M.moe_mlp(params, cfg, x)[0]
        layer_ms = time_ms(lambda: M.moe_mlp(params, cfg, x))
        with buffer_path():
            buffer_y = M.moe_mlp(params, cfg, x)[0]
            buffer_ms = time_ms(lambda: M.moe_mlp(params, cfg, x))
    torch.cuda.synchronize()
    diff = ((grouped_y.float() - buffer_y.float()).abs().max()
            / buffer_y.float().abs().max()).item()
    assert math.isfinite(diff), diff
    return {"arch": cfg.name,
            "shape": {"rows": t, "experts": e, "top_k": k, "d": d,
                      "d_expert": fe, "entries": n, "experts_routed": active,
                      "dtype": "bfloat16"},
            "max_abs_err": worst["abs"], "max_rel_err": worst["rel"],
            "limit": f"{GROUPED_REL_TOL} x the largest output",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch._grouped_mm x 3 on pre-gathered rows",
            "library_max_rel_err": library_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": n_bytes, "flops": flops,
            "moe_layer_ms": layer_ms, "buffer_path_layer_ms": buffer_ms,
            "grouped_vs_buffer_rel_diff": diff}


def grouped_decode_syncs(cfg, rows: int, steps: int = 3) -> dict:
    """Engine decode steps at ``rows`` rows (the chat cell's 256) on `cfg`
    at full depth, profile hooks on, each a replay of the step's graph:
    each makes exactly one synchronising call (its read of the tokens,
    `set_sync_debug_mode`) and counts one grouped product a MoE layer, and
    one more runs its up and down kernels on the card (`on_device`).
    Every row decodes, active or not, so two requests suffice."""
    import warnings
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    params = serve_params(cfg, None)
    eng = ServeEngine(cfg, batch=rows, max_seq=64, prefill_len=16,
                      instrument=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 16).astype(
            np.int32), 40))
    while eng.queue:
        eng.step(params)
    eng.step(params)                     # a first decode step: warm
    eng.step(params)                     # the capture of its graph
    torch.cuda.synchronize()
    syncs, launches, step_ms = [], [], []
    for _ in range(steps):
        before = read_counters()["grouped_mlp"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                eng.step(params)
                step_ms.append(1e3 * (time.perf_counter() - t0))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append([str(w.message).splitlines()[0][:100] for w in caught
                      if str(w.message).startswith(
                          "called a synchronizing CUDA operation")])
        launches.append(read_counters()["grouped_mlp"] - before)
    assert eng.kinds_log[-steps:] == ["decode"] * steps, eng.kinds_log
    assert all(len(s) == 1 for s in syncs), syncs
    assert launches == [grouped_layers(cfg)] * steps, launches
    # the grouped kernels that one more replayed step ran on the card
    want = expected_events({"grouped_mlp": grouped_layers(cfg)})
    _, events, _ = on_device(lambda: eng.step(params), want)
    assert eng.kinds_log[-1] == "decode", eng.kinds_log
    assert events["grouped_mlp"] == want["grouped_mlp"], events
    del eng, params
    return {"arch": cfg.name, "rows": rows, "steps": steps,
            "syncs_per_step": [len(s) for s in syncs], "sync": syncs[0][0],
            "grouped_launches_per_step": launches,
            "grouped_events_of_a_step": events["grouped_mlp"],
            "step_ms": step_ms}


# The benchmark cell deepseek-v2-lite.longdoc's shapes
# (portbench/traffic/longdoc.json): 56 rows over caches of 18 432 positions,
# prompts of 16 384 tokens
LONGDOC = dict(rows=56, max_seq=18432, prompt_len=16384)
# K1 at latent attention's widths is held against its plain version whole up
# to this length; beyond it the plain scores (16 heads x S x S in f32: 17 GB
# at 16k) do not fit beside the rest, so blocks of query rows are held
# against the quadratic softmax (`attend_reference`, f32) over their keys,
# and the plain time is the port's streaming plain path's
# (`attend_chunked`, blocks of 1024, skipping masked blocks)
K1_PLAIN_WHOLE = 4096
K1_CHECK_ROWS = 1024


def full_width_latent_k1(gen, cfg, s: int) -> dict:
    """K1 at latent attention's expanded prefill, qk 192 / v 128 at the
    model's scale, causal over ``s`` tokens (one row): against its plain
    version (see `K1_PLAIN_WHOLE`), timed beside the plain version and one
    library call (`is_causal`), with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plan,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models import attention as A
    from repro_torch.models.mla import softmax_scale
    dtype = torch.bfloat16
    scale = softmax_scale(cfg)
    m, h = cfg.mla, cfg.attn.n_heads
    dqk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    q, k = (_randn(gen, (1, s, h, dqk), dtype) for _ in range(2))
    v = _randn(gen, (1, s, h, dv), dtype)
    got = flash_attention(q, k, v, group=1, scale=scale)
    worst: dict = {}
    pos = torch.arange(s, device="cuda")[None]
    layout = A.HeadLayout.make(cfg.attn, 1)
    if s <= K1_PLAIN_WHOLE:
        want = flash_attention_plain(q, k, v, group=1, scale=scale)
        _check("flash_attention", got, want, dtype, ("latent", s), worst)
        del want
        checked = "whole"

        def plain():
            return flash_attention_plain(q, k, v, group=1, scale=scale)
        plain_call = "flash_attention_plain"
    else:
        starts = sorted({0, (s // 2) // K1_CHECK_ROWS * K1_CHECK_ROWS,
                         s - K1_CHECK_ROWS})
        for a in starts:
            rows = slice(a, a + K1_CHECK_ROWS)
            want = A.attend_reference(
                q[:, rows].float(), k[:, :rows.stop].float(),
                v[:, :rows.stop].float(), pos[:, rows], pos[:, :rows.stop],
                layout, causal=True, window=-1, scale=scale)
            _check("flash_attention", got[:, rows], want, dtype,
                   ("latent", s, a), worst)
            del want
        checked = [[a, a + K1_CHECK_ROWS] for a in starts]

        def plain():
            return A.attend_chunked(q, k, v, pos, pos, layout, causal=True,
                                    window=-1, causal_skip=True, scale=scale)
        plain_call = "attend_chunked (blocks of 1024, causal skip)"
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib_call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)
    lib = lib_call().transpose(1, 2)
    lib_err = (lib.float() - got.float()).abs().max().item()
    del got, lib
    gc.collect()
    torch.cuda.empty_cache()
    ms = time_ms(lambda: flash_attention(q, k, v, group=1, scale=scale))
    plain_ms = time_ms(plain, warmup=1, reps=3, inner=2)
    library_ms = time_ms(lib_call)
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + s * h * dv)
    flops = 2.0 * h * (s * (s + 1) / 2) * (dqk + dv)
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    plan = attention_plan(1, s, h, dqk, dtype, dv)
    return {"shape": {"B": 1, "S": s, "H": h, "KV": h, "hd": dqk, "dv": dv,
                      "scale": scale, "dtype": "bfloat16", "causal": True},
            "checked_rows": checked, "plain_call": plain_call,
            "library_call": "is_causal",
            "plan": {"bq": plan.bq, "bk": plan.bk, "warps": plan.warps,
                     "kv_warps": plan.kv_warps, "blocks": plan.blocks,
                     "smem_bytes": plan.smem_bytes},
            "max_abs_err": worst["bfloat16"], "limit": TOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err_vs_kernel": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": n_bytes, "flops": flops}


def _mla_inputs(gen, cfg, b, s, lens):
    h, r = cfg.attn.n_heads, cfg.mla.kv_lora_rank
    d = r + cfg.mla.qk_rope_head_dim
    return (_randn(gen, (b, h, d), torch.bfloat16),
            _randn(gen, (b, s, d), torch.bfloat16),
            torch.tensor(lens, device="cuda", dtype=torch.int32))


def sweep_mla_decode(gen) -> dict:
    """The latent-decode kernel against its plain version over small shapes
    at deepseek-v2-lite's widths (16 and 32 heads of 576, out 512): one key,
    a tile's edge, a row past the cache, split keys merged."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as MD
    from repro_torch.models.mla import softmax_scale
    cfg = get_config("deepseek-v2-lite")
    scale = softmax_scale(cfg)
    worst: dict = {}
    cases = ((1, 16, 64, [1]), (3, 16, 200, [64, 65, 200]),
             (4, 32, 1000, [999, 1, 300, 1500]),
             (8, 16, 4096, [4096 - 37 * i for i in range(8)]))
    for b, h, s, lens in cases:
        c = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                              n_heads=h))
        q, cache, lengths = _mla_inputs(gen, c, b, s, lens)
        want = MD.mla_decode_plain(q, cache, lengths, scale=scale)
        _check("mla_decode", MD.mla_decode(q, cache, lengths, scale=scale),
               want, torch.bfloat16, ("sweep", b, h, s), worst)
        for n in (1, 3):
            chunk = -(-s // n // MD.KEY_TILE) * MD.KEY_TILE
            _check("mla_decode", MD.launch_with_split(
                q, cache, lengths, scale=scale, n_splits=-(-s // chunk),
                chunk=chunk), want, torch.bfloat16, ("sweep", b, h, s, n),
                worst)
    return {"cases": len(cases), "max_abs_err": worst}


def full_width_mla_decode(gen, cfg, b: int, s: int, lens) -> dict:
    """The latent-decode kernel at ``b`` rows of lengths ``lens`` over a
    cache of ``s`` (one layer's; at the long-document cell's shape 1.19 GB,
    so no launch finds its rows in L2), against its plain version, timed
    beside the plain version and one library call
    (`F.scaled_dot_product_attention` over one head whose 16 query rows are
    the row's heads, the latent its keys and values, the lengths a boolean
    mask), with
    its bound: the rows' keys, the queries and the outputs, each once, or
    the two products over the keys.  The split plan's choice, and 4, 16 and
    32 splits beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import mla_decode as MD
    from repro_torch.models.mla import softmax_scale
    dtype = torch.bfloat16
    scale = softmax_scale(cfg)
    r = cfg.mla.kv_lora_rank
    q, cache, lengths = _mla_inputs(gen, cfg, b, s, lens)
    _, h, d = q.shape
    worst: dict = {}
    want = MD.mla_decode_plain(q, cache, lengths, scale=scale)
    _check("mla_decode", MD.mla_decode(q, cache, lengths, scale=scale), want,
           dtype, ("timed", b, s), worst)
    rel = worst["bfloat16"] / want.float().abs().max().item()
    keys = [min(x, s) for x in lens]
    mask = (torch.arange(s, device="cuda")[None]
            < torch.tensor(keys, device="cuda")[:, None])[:, None, None]
    qt, kt, vt = q[:, None], cache[:, None], cache[:, None, :, :r]

    def lib_call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale)
    lib_err = (lib_call()[:, 0].float() - want.float()).abs().max().item()
    del want
    n_splits, chunk = MD.split_plan(b, h, s)
    ms = time_ms(lambda: MD.mla_decode(q, cache, lengths, scale=scale))
    by_splits = {}
    for n in (4, 16, 32):
        c = -(-s // n // MD.KEY_TILE) * MD.KEY_TILE
        by_splits[-(-s // c)] = time_ms(lambda: MD.launch_with_split(
            q, cache, lengths, scale=scale, n_splits=-(-s // c), chunk=c))
    plain_ms = time_ms(lambda: MD.mla_decode_plain(q, cache, lengths,
                                                   scale=scale),
                       warmup=1, reps=3, inner=2)
    library_ms = time_ms(lib_call, warmup=1, reps=3, inner=2)
    n_keys = sum(keys)
    n_bytes = 2 * (q.numel() + n_keys * d + b * h * r) + 4 * b
    flops = 2.0 * h * n_keys * (d + r)
    bound_ms, bound_by = _bound(n_bytes, flops, dtype)
    return {"shape": {"B": b, "S": s, "H": h, "d": d, "out": r,
                      "lengths": [min(lens), max(lens)], "keys": n_keys,
                      "scale": scale, "dtype": "bfloat16"},
            "plan": {"n_splits": n_splits, "chunk": chunk},
            "ms_by_splits": by_splits,
            "library_call": "one head, the heads as query rows, the "
                            "lengths as a boolean mask",
            "max_abs_err": worst["bfloat16"], "max_rel_err": rel,
            "limit": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": n_bytes, "flops": flops}


def latent_attention_shapes(gen, path, cfg, batch, max_seq,
                            prefill_len) -> dict:
    """Latent attention's two kernels at the path's shapes (K1 over its
    prefill; the latent decode at its batch, lengths as
    `full_width_flash_decode` gives them) and at the long-document cell's
    (`LONGDOC`: K1 over a 16k prompt; the latent decode at 56 rows whose
    lengths run evenly from the prompt's end to the cache's)."""
    lens = [prefill_len + 1 + 9 * i for i in range(batch)]
    lens[-1] = max_seq + 5
    if batch > 2:
        lens[-2] = max_seq - 1
    b, s, p = LONGDOC["rows"], LONGDOC["max_seq"], LONGDOC["prompt_len"]
    cell = [p + 1 + (s - p - 1) * i // (b - 1) for i in range(b)]
    out = {"flash_attention": [], "mla_decode": []}
    for label, n in ((path, prefill_len), (f"{path}, longdoc cell", p)):
        out["flash_attention"].append(dict(
            arch=label, **full_width_latent_k1(gen, cfg, n)))
        gc.collect()
        torch.cuda.empty_cache()
    for label, args in ((path, (batch, max_seq, lens)),
                        (f"{path}, longdoc cell", (b, s, cell))):
        out["mla_decode"].append(dict(
            arch=label, **full_width_mla_decode(gen, cfg, *args)))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_kernels(paths, batch) -> dict:
    """Every kernel over its sweep, then at the full-width shapes that the
    serving paths give it, each timed (the enc-dec path's K1 at its encoder
    shape too; a quantized path takes its base path's shapes, K2 reading
    the dequantized bf16 cache; a latent attention path's K1 at qk 192 / v
    128 and its latent decode, at the path's shapes and the long-document
    cell's, `latent_attention_shapes`), and the attention kernels at one
    long shape each (at the first dense path's widths)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {name: {"full_width": []} for name in KERNELS}
    out["flash_attention"]["sweep"] = sweep_flash_attention(gen)
    out["flash_decode"]["sweep"] = sweep_flash_decode(gen)
    out["ssd_intra"]["sweep"] = sweep_ssd(gen)
    out["grouped_mlp"]["sweep"] = sweep_grouped_mlp(gen)
    out["mla_decode"]["sweep"] = sweep_mla_decode(gen)
    for path, cfg, prefill_len, max_seq in paths:
        if "/" in path:                 # a variant: its base path's shapes
            continue
        n_attn = n_attention_layers(cfg)
        if cfg.family == "encdec":
            out["flash_attention"]["full_width"].append(dict(
                arch=f"{path} encoder", **full_width_flash_attention(
                    gen, cfg, cfg.n_frames, causal=False)))
        # a path whose layers differ in window (gemma3-4b's local and
        # global layers) is timed at each, over that many stacked layers
        wins = cfg.layer_windows()
        kinds = sorted(set(wins)) if len(set(wins)) > 1 else [-1]
        if cfg.mla is not None:
            for name, rows in latent_attention_shapes(
                    gen, path, cfg, batch, max_seq, prefill_len).items():
                out[name]["full_width"] += rows
            kinds = []
        for w in (kinds if n_attn else []):
            label, layers = path, n_attn
            if len(kinds) > 1:
                label = f"{path} ({'global' if w < 0 else f'window {w}'})"
                layers = wins.count(w)
            out["flash_attention"]["full_width"].append(dict(
                arch=label, **full_width_flash_attention(
                    gen, cfg, prefill_len, window=w)))
            out["flash_decode"]["full_width"].append(dict(
                arch=label, **full_width_flash_decode(
                    gen, cfg, batch, max_seq, prefill_len, layers,
                    window=w)))
        if cfg.family in ("ssm", "hybrid"):
            out["ssd_intra"]["full_width"].append(
                full_width_ssd(gen, cfg, prefill_len))
        if grouped_layers(cfg):
            for rows in ((LONGDOC["rows"], batch) if cfg.mla is not None
                         else MOE_DECODE_ROWS + (batch,)):
                out["grouped_mlp"]["full_width"].append(
                    full_width_grouped_mlp(gen, cfg, rows))
                gc.collect()
                torch.cuda.empty_cache()
            if "decode_syncs" not in out["grouped_mlp"]:
                out["grouped_mlp"]["decode_syncs"] = grouped_decode_syncs(
                    cfg, MOE_DECODE_ROWS[0])
        gc.collect()
        torch.cuda.empty_cache()
    dense = [p[1] for p in paths if p[1].family == "dense"]
    if dense:
        for name, res in long_shapes(gen, dense[0]).items():
            out[name]["long"] = res
    emit("kernels", tolerance={"float32": TOL[torch.float32],
                               "bfloat16": TOL[torch.bfloat16],
                               "ssd_intra_relative":
                                   "2e-4 + eps_f32 * max|cum|"}, **out)
    return out


def phase_plans(paths, batch) -> None:
    """Optional (`--phases ...,plans`): the measurements behind the launch
    plans.  At each attention path's shapes, K1 with every bf16 tile choice
    (8, 4 and 2 row warps) and K2 with 1 to 16 splits of the kv range; at
    each SSM path's prefill shape, K3 with every head group its head_dim
    allows, each with and without pairing t tiles; each held against the
    plain version and timed as in the `kernels` phase (K2 over the stacked
    layers); the plans' own choices are named.  A latent attention path has
    no K2 and its own split plan: the `kernels` phase times the latent
    decode at 4 to 32 splits."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.bfloat16
    tile = build.load().rt_flash_decode_tile()
    for path, cfg, prefill_len, max_seq in paths:
        if cfg.family in ("ssm", "hybrid"):
            emit("plans", arch=path, ssd_intra=plans_ssd(gen, cfg,
                                                         prefill_len))
        if not n_attention_layers(cfg) or "/" in path or cfg.mla is not None:
            continue
        a = cfg.attn
        h, kv, hd = a.n_heads, a.n_kv_heads, a.head_dim
        q, k, v = (_randn(gen, (1, prefill_len, n, hd), dtype)
                   for n in (h, kv, kv))
        want = fa.flash_attention_plain(q, k, v, group=h // kv, cap=a.softcap)
        k1 = {}
        for rows in (8, 4, 2):
            plan = fa.bf16_plan(1, prefill_len, h, hd, rows)
            call = lambda: fa.launch_with_plan(  # noqa: E731
                q, k, v, plan, causal=True, window=-1, cap=a.softcap)
            _check("flash_attention", call(), want, dtype, ("plans", rows), {})
            k1[rows] = time_ms(call)
        del q, k, v, want
        n_layers = n_attention_layers(cfg)
        lens = [prefill_len + 1 + 9 * i for i in range(batch)]
        lens[-1], lens[-2] = max_seq + 5, max_seq - 1
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        q = _randn(gen, (batch, 1, h, hd), dtype)
        kc, vc = (_randn(gen, (n_layers, batch, max_seq, kv, hd), dtype)
                  for _ in range(2))
        want = fd.flash_decode_plain(q, kc[0], vc[0], lengths, group=h // kv,
                                     cap=a.softcap)
        k2 = {}
        for n in (1, 2, 4, 8, 16):
            chunk = -(-max_seq // (n * tile)) * tile
            state = {"i": 0}

            def call(layer=None):
                state["i"] = (state["i"] + 1) % n_layers
                i = state["i"] if layer is None else layer
                return fd.launch_with_split(
                    q, kc[i], vc[i], lengths, group=h // kv, window=-1,
                    cap=a.softcap, n_splits=-(-max_seq // chunk), chunk=chunk)
            _check("flash_decode", call(0), want, dtype, ("plans", n), {})
            k2[n] = time_ms(call, inner=n_layers)
        del q, kc, vc
        emit("plans", arch=path,
             flash_attention={"shape": [1, prefill_len, h, kv, hd],
                              "chosen_rows": fa.attention_plan(
                                  1, prefill_len, h, hd, dtype).bq // 16,
                              "ms_by_rows": k1},
             flash_decode={"shape": [batch, max_seq, h, kv, hd],
                           "lengths": lens, "stacked_layers": n_layers,
                           "chosen_splits": fd.split_plan(
                               batch, kv, max_seq, tile)[0],
                           "ms_by_splits": k2})


def plans_ssd(gen, cfg, prefill_len: int) -> dict:
    """K3 at the prefill shape of `cfg` with every bf16 plan: each head
    group of `TC_HEADS[hp]`, t tiles alone and paired."""
    from repro_torch.kernels import ssd as K
    from repro_torch.models.ssm import ssm_dims
    _, nh = ssm_dims(cfg)
    b, s, hp, n, chunk = 1, prefill_len, cfg.ssm.head_dim, cfg.ssm.d_state, \
        cfg.ssm.chunk
    args = _ssd_inputs(gen, b, s, nh, hp, n, torch.bfloat16)
    want = K.ssd_intra_plain(*args, chunk)
    chosen = K.ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16)
    ms = {}
    for g in K.TC_HEADS[hp]:
        for pair in (False, True):
            plan = K.ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16,
                              heads_per_block=g, pair=pair)
            call = lambda: K.launch_with_plan(*args, chunk, plan)  # noqa: E731
            _check_ssd(call(), want, ("plans", g, pair), {})
            ms[f"heads {g}, {'paired' if pair else 'alone'}"] = {
                "ms": time_ms(call), "blocks": plan.blocks}
    return {"shape": [b, s, nh, hp, n, chunk],
            "chosen": {"heads_per_block": chosen.heads_per_block,
                       "pair": chosen.pair},
            "plain_ms": time_ms(lambda: K.ssd_intra_plain(*args, chunk)),
            "ms_by_plan": ms}


_LAUNCHES0: dict = {}         # the wrappers' counts at `reset_counters`


def reset_counters() -> None:
    """Take the kernel wrappers' launch counts, as the registry holds them,
    for 0 (`read_counters`)."""
    from repro_torch.kernels import build
    _LAUNCHES0.update(build.launches())


def read_counters() -> dict:
    """Each kernel wrapper's launches since `reset_counters`, as the host
    counted them (a replayed CUDA graph counts again what its capture
    counted)."""
    from repro_torch.kernels import build
    return {k: n - _LAUNCHES0.get(k, 0) for k, n in build.launches().items()}


# device events of one launch, where a wrapper's launch makes more than one
# (the grouped product: its up and its down kernel)
EVENTS_PER_LAUNCH = {"grouped_mlp": 2}


def on_device(fn, expected: dict):
    """``fn()`` under ``torch.profiler``, and the port's kernels' device
    events in it by name (`hlo_analysis.PORT_KERNEL_NAMES`), as (``fn``'s
    result, the events of each kernel, the profiles taken).  Each kernel of
    a replayed CUDA graph is an event of its own, so the count rests on what
    the card ran, not on what the host counted.  The profile starts with
    `hlo_analysis.LEAD_IN_LAUNCHES` fills, as `hlo_analysis.profile_call`'s
    do; a profile may still lose an event (never add one), so ``fn`` runs
    again, up to `hlo_analysis.PROFILE_ATTEMPTS` times, while a kernel
    reads fewer events than ``expected`` (the events of each kernel) and
    none reads more.  ``fn`` must bear being run again."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import hlo_analysis as H
    kernel_of = {n: k for k, names in H.PORT_KERNEL_NAMES.items()
                 for n in names}
    for attempt in range(1, H.PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead = torch.zeros(1, device="cuda")
            for _ in range(H.LEAD_IN_LAUNCHES):
                lead.fill_(0.0)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        events = dict.fromkeys(H.PORT_KERNEL_NAMES, 0)
        for e in prof.profiler.kineto_results.events():
            kernel = kernel_of.get(H.kernel_name(e.name()))
            if kernel is not None and e.device_type().name != "CPU":
                events[kernel] += 1
        short = any(events[k] < n for k, n in expected.items())
        over = any(events[k] > n for k, n in expected.items())
        if over or not short:
            break
    return out, events, attempt


def expected_events(launches: dict) -> dict:
    """The device events that ``launches`` make (`EVENTS_PER_LAUNCH`)."""
    return {k: n * EVENTS_PER_LAUNCH.get(k, 1) for k, n in launches.items()}


def graph_counts() -> dict:
    """The engine's captures and replays of its decode step's graph."""
    from repro_torch import obs
    reg = obs.metrics()
    return {k: reg.value(f"serve.decode_graph_{k}") or 0
            for k in ("captures", "replays")}


@contextlib.contextmanager
def eager_decode():
    """Engines made and run inside decode eagerly: the engine's rule
    (`serve.engine.graph_captures`) answers false, as on the CPU."""
    from repro_torch.serve import engine as E
    rule = E.graph_captures
    E.graph_captures = lambda *args: False
    try:
        yield
    finally:
        E.graph_captures = rule


def n_attention_layers(cfg) -> int:
    """The cached (decoder) self-attention layers of a step: the hybrid's
    attention is one shared block per group, the enc-dec family's are its
    decoder's (the encoder's run in the prefill only)."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
            "encdec": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}[cfg.family]


def grouped_layers(cfg) -> int:
    """The MoE layers whose decode step takes the grouped kernel
    (`models.moe.grouped_route`): every MoE layer (those after the leading
    dense ones) of a MoE configuration the kernel computes in its compute
    dtype, else none."""
    from repro_torch.configs.base import dtype_of
    from repro_torch.kernels.moe_grouped import takes
    if cfg.family != "moe" or not takes(cfg.glu, cfg.act,
                                        dtype_of(cfg.compute_dtype),
                                        cfg.d_model, cfg.moe.d_expert):
        return 0
    return cfg.n_layers - cfg.n_dense_layers


def expected_launches(cfg, prefills: int, decodes: int) -> dict:
    """Launches of each kernel on a serving run: K1 per attention layer of a
    prefill (the enc-dec family's encoder layers, non-causal, included), K2
    per attention layer of a decode step, or with latent attention the
    latent decode, K3 per Mamba2 layer of a prefill, the grouped MoE kernel
    per MoE layer of a decode step."""
    n_attn = n_attention_layers(cfg)
    n_enc = cfg.n_enc_layers if cfg.family == "encdec" else 0
    n_ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_latent = n_attn if cfg.mla is not None else 0
    return {"flash_attention": prefills * (n_enc + n_attn),
            "flash_decode": decodes * (n_attn - n_latent),
            "ssd_intra": prefills * n_ssm,
            "grouped_mlp": decodes * grouped_layers(cfg),
            "mla_decode": decodes * n_latent}


def serve_params(cfg, given):
    """The path's random weights, seed 0, drawn on `SERVE_INIT_DEVICE`'s
    generator; a quantized path's are `quantize_params` of its base path's
    (``given``, when the base path ran just before; else drawn here)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    if given is not None:
        return given["params"]
    base = dataclasses.replace(cfg, weight_quant="none", cache_quant="none")
    model = build_model(base)
    params = model.init(torch.Generator(
        device=SERVE_INIT_DEVICE.get(cfg.name, "cpu")).manual_seed(0))
    if cfg.weight_quant == "none":
        return params
    quant = L.quantize_params(params, model.axes())
    del params
    return quant


NIBBLE_STD = math.sqrt((16 ** 2 - 1) / 12)     # a uniform value in [-8, 7]


def _init_std(spec) -> float:
    """The std of a float ParamSpec's random init (`ParamSpec.instantiate`)."""
    if spec.init == "scaled":
        return spec.scale / math.sqrt(max(spec.shape[0] if spec.shape else 1,
                                          1))
    return spec.scale * 0.02


def int4_params(cfg):
    """The int4 path's weights, with what the allocator gave for them.  Every
    payload holds random nibbles from seed 0 (the card's generator): test
    data, not a quantization (the port has no int4 quantizer, nor has the
    reference).  Every scale is its kernel's float init std over a nibble's
    (`NIBBLE_STD`), so that the layers see activations of the bf16 path's
    size; the other leaves are drawn as the bf16 path draws them.  The bytes
    that the new blocks ask for must equal 0.5 B a payload value, 4 B a
    scale and 2 B every other value (`_bytes_check`)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    model = build_model(cfg)
    specs = model.specs()
    floats = build_model(dataclasses.replace(cfg, weight_quant="none")).specs()
    nibbles = torch.Generator(device="cuda").manual_seed(0)

    def fill(tree, fspecs):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, fspecs[k])
            elif k == "kernel_q":
                v.random_(generator=nibbles)          # both nibbles at random
                tree["kernel_scale"].fill_(_init_std(fspecs["kernel"])
                                           / NIBBLE_STD)

    def build():
        params = model.init(torch.Generator(
            device=SERVE_INIT_DEVICE.get(cfg.name, "cpu")).manual_seed(0))
        fill(params, floats)
        return params
    params, alloc = _allocated_by(build)
    leaves = L.tree_leaves(specs)
    payload = sum(math.prod(s.shape) for s in leaves if s.dtype == "int4")
    scales = sum(math.prod(s.shape) for s in leaves if s.dtype == "float32")
    other = sum(math.prod(s.shape) for s in leaves if s.dtype is None)
    predicted = int(0.5 * payload) + 4 * scales + 2 * other
    check = _bytes_check("int4 weights", predicted, alloc)
    return params, {"payload_values": payload, "scale_values": scales,
                    "other_values": other,
                    "predicted_bytes": predicted, **check,
                    "int4_payload_bytes": int(0.5 * payload)}


def _unpacked(tree, dt):
    """A parameter tree with every quantized kernel dequantized to ``dt``
    (`layers.get_kernel`): the same weights for the plain path."""
    from repro_torch.models import layers as L
    if not isinstance(tree, dict):
        return tree
    if "kernel_q" in tree:
        out = {k: v for k, v in tree.items()
               if k not in ("kernel_q", "kernel_scale")}
        out["kernel"] = L.get_kernel(tree, dt)
        return out
    return {k: _unpacked(v, dt) for k, v in tree.items()}


def path_inputs(cfg, prompt):
    """The checks' batch: the prompt of request 0 and its reverse, with
    random frames (enc-dec) or patches (VLM) from a seed, f32."""
    toks = torch.from_numpy(prompt)[None].to("cuda")
    batch_in = {"tokens": torch.cat([toks, toks.flip(1)]).long()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.family == "encdec":
        batch_in["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                         generator=gen, device="cuda")
    if cfg.n_patches:
        batch_in["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                          generator=gen, device="cuda")
    return batch_in


# tokens/s of the serving paths run so far (the int4 path prints them)
TOKENS_PER_S = {}


def phase_serve(path, cfg, batch, max_seq, prefill_len, n_requests,
                given=None):
    """Serve 16 requests on the path; returns (engine, launches (as the
    card's kernel events count them), params, the kernel path's and the f32
    plain path's logits on the checks' batch).  ``given``: for a quantized
    path, its parameters and its base path's logits."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeEngine, SyntheticRequests

    t0 = time.perf_counter()
    model = build_model(cfg)                               # on the card
    weight_bytes = None
    if cfg.weight_quant == "int4":
        params, weight_bytes = int4_params(cfg)
    else:
        params = serve_params(cfg, given)
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

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, batch=batch, max_seq=max_seq,
                      prefill_len=prefill_len)
    # ---- the main path: counters to 0 just before, read just after ---------
    reset_counters()
    graphs0 = graph_counts()
    stats = eng.run(params, requests())
    counted = read_counters()
    graphs = {k: v - graphs0[k] for k, v in graph_counts().items()}
    peak = torch.cuda.max_memory_allocated()

    prefills = eng.kinds_log.count("prefill")
    decodes = eng.kinds_log.count("decode")
    # a windowed path's every prompt, so every decode step too, is longer
    # than its local layers' window
    assert all(w < prefill_len for w in cfg.layer_windows()), \
        (cfg.layer_windows(), prefill_len)
    assert stats["requests"] == n_requests, stats
    assert prefills == n_requests, (prefills, n_requests)
    expected = expected_launches(cfg, prefills, decodes)
    # what the host counted: a replay counts again what its capture did
    assert counted == expected, counted
    outputs = {r.req_id: r.output for r in eng.done}
    for out in outputs.values():
        assert len(out) >= 2 and all(0 <= t < cfg.vocab_size for t in out)
    # every decode step replays the step's graph but the warm-up and the
    # capture, and gives the tokens of the same path decoding eagerly
    assert graphs == {"captures": 1, "replays": decodes - 2}, graphs

    # what the card ran: the same requests on a fresh engine under
    # torch.profiler, its kernels counted by their device events
    def served():
        e = ServeEngine(cfg, batch=batch, max_seq=max_seq,
                        prefill_len=prefill_len, instrument=False)
        e.run(params, requests())
        return e
    want_events = expected_events(expected)
    profiled, events, profiles = on_device(served, want_events)
    assert profiled.kinds_log == eng.kinds_log
    assert events == want_events, (events, want_events)
    assert {r.req_id: r.output for r in profiled.done} == outputs
    del profiled
    launches = {k: n // EVENTS_PER_LAUNCH.get(k, 1)
                for k, n in events.items()}
    with eager_decode():
        eager = ServeEngine(cfg, batch=batch, max_seq=max_seq,
                            prefill_len=prefill_len, instrument=False)
        eager.run(params, requests())
    eager_outputs = {r.req_id: r.output for r in eager.done}
    del eager
    assert eager_outputs == outputs
    from repro_torch.configs import get_config
    full = get_config(cfg.name)
    reduced = ({"n_layers": [full.n_layers, cfg.n_layers]}
               if cfg.n_layers != full.n_layers else None)
    emit("serve", arch=path, n_layers=cfg.n_layers, reduced=reduced,
         weight_quant=cfg.weight_quant, cache_quant=cfg.cache_quant,
         params=n_params, params_analytic=cfg.param_count(),
         init_seconds=init_s,
         init_generator=(
             f"quantize_params of {path.split('/')[0]}'s"
             if cfg.weight_quant == "int8" else
             "payloads: random nibbles, the card's generator; the rest: "
             f"{SERVE_INIT_DEVICE.get(cfg.name, 'cpu')}"
             if cfg.weight_quant == "int4"
             else SERVE_INIT_DEVICE.get(cfg.name, "cpu")),
         batch=batch, max_seq=max_seq,
         prefill_len=prefill_len, stats=stats, prefills=prefills,
         decode_iterations=decodes, launches=launches,
         launches_counted=counted, profiles_taken=profiles,
         decode_graph=dict(graphs, tokens_as_eager=True),
         peak_memory_bytes=peak, weight_bytes=weight_bytes,
         tokens_per_s_of=dict(TOKENS_PER_S) if weight_bytes else None)
    TOKENS_PER_S[path] = stats["tokens_per_s"]

    # ---- the kernel path against the plain path, on the card ---------------
    # The same prefill and one decode step through the kernels, through their
    # plain versions (attention_impl="reference"), and through the plain
    # versions with f32 activations.  In bf16 the two paths sum in another
    # order, so some attention outputs round to the neighbouring bf16 value,
    # and the differences pass through every later layer.  The limit is what
    # bf16 itself costs on this input: the kernel path may lie no farther
    # from the plain path than the plain path lies from the f32 computation
    # (and never needs to be closer than 5e-2 on logits of size O(1)).  On
    # the SSM paths that rule is loose (a random-weight Mamba2 stack turns
    # bf16 rounding into logit changes of about half their size), so the
    # kernel path is also run with f32 activations and held to the f32 plain
    # path within PATH_F32_REL_TOL of the largest logit.  The plain path of
    # the SSD is `ssm_impl="chunked"` (K3's plain version is the same
    # function in the same order).
    #
    # A random-weight MoE stack amplifies rounding as the Mamba2 stacks do
    # (the reference's init gives the stacked expert weights a std of
    # 1/sqrt(n_experts)): with the same routing in every layer, f32 sums in
    # another order move olmoe-1b-7b's logits by up to 1e-2 of the largest,
    # where qwen3-1.7b's move by 6e-6, and bf16 activations move them by
    # more than their size, so in bf16 the two paths' differences are
    # equally large and the bf16 rule can only be met by chance.  On the MoE
    # path the bf16 differences are therefore reported and not held; the
    # path is held in f32 activations (PATH_F32_REL_TOL, with bf16 as the
    # control that must fail it) and, in bf16, one layer deep: the first
    # attention block through K1 against its plain version
    # (`first_attention_vs_plain`).  Beside them, the share of (token,
    # layer) routing decisions that differ between two paths, in all and by
    # layer.  The enc-dec, VLM and int8 paths are held by the whole-model
    # rules and one layer deep (for the enc-dec family, the encoder's first
    # block: K1 not causal over the frames).
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference",
                                  ssm_impl="chunked")
    #
    # The plain paths run with the grouped route closed (`buffer_path`), so
    # the kernel path's decode step, whose experts take the grouped kernel
    # on a MoE path, is compared with one that has no grouped kernel; on such
    # a path the plain model with the route open (`plain_grouped`) is run
    # too, and its difference from the plain path (the grouped kernel alone,
    # through the whole model) is reported beside the others.
    #
    # Latent attention's kernels take bf16 alone (the latent decode; K1 with
    # v narrower than qk), so a latent attention path has no f32 kernel run:
    # its whole-model differences are reported, and it is held one layer
    # deep in bf16, the prefill's attention block through K1 and a decode
    # step's latent attention through the latent decode, each against its
    # plain version (`first_latent_decode_vs_plain`).
    models = {"kernel": model, "plain": build_model(ref_cfg),
              "f32": build_model(dataclasses.replace(
                  ref_cfg, compute_dtype="float32"))}
    if cfg.mla is None:
        models["kernel_f32"] = build_model(dataclasses.replace(
            cfg, compute_dtype="float32"))
    if grouped_layers(cfg):
        models["plain_grouped"] = build_model(ref_cfg)
    batch_in = path_inputs(cfg, requests()[0].prompt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits, routes = path_logits(models, params, batch_in, max_seq,
                                 on_buffer=("plain", "f32"))
    errs = {}
    for what in ("prefill_logits", "decode_logits"):
        e = logit_errs(logits, what)
        e["limit"] = max(5e-2, e["plain_vs_f32"])
        e["f32_limit"] = PATH_F32_REL_TOL[cfg.family] * e["logits_abs_max"]
        assert math.isfinite(e["kernel_vs_plain"]), (what, e)
        if cfg.family == "moe":
            e["bf16_held"] = False
            ran = {pair: ab for pair, ab in PAIRS.items() if pair in e}
            e["routing_differs"] = {
                pair: routing_differs(routes[a][what], routes[b][what])
                for pair, (a, b) in ran.items()}
            e["routing_differs_by_layer"] = {
                pair: routing_differs(routes[a][what], routes[b][what],
                                      by_layer=True)
                for pair, (a, b) in ran.items()}
            if "plain_grouped" in logits:
                e["plain_grouped_vs_plain"] = (
                    logits["plain_grouped"][what]
                    - logits["plain"][what]).abs().max().item()
                e["routing_differs"]["plain_grouped_vs_plain"] = \
                    routing_differs(routes["plain_grouped"][what],
                                    routes["plain"][what])
        else:
            assert e["kernel_vs_plain"] <= e["limit"], (what, e)
            assert e["kernel_vs_f32"] <= 1.25 * e["plain_vs_f32"], (what, e)
        if "kernel_f32" in logits:
            assert math.isfinite(e["f32_kernel_vs_plain"]), (what, e)
            assert e["f32_kernel_vs_plain"] <= e["f32_limit"], (what, e)
            # the bf16 control: bf16 activations alone fail the f32 limit
            assert e["plain_vs_f32"] > e["f32_limit"], (what, e)
        if given is not None:
            # int8 weights and cache against the base path's bf16 weights,
            # reported (the reference's rule, < 0.08, is held on the CPU at
            # the reduced size): in bf16 activations (the kernel paths), in
            # f32 activations (the plain paths: quantization alone), and,
            # beside them, what bf16 activations alone move the base path
            base = given["logits"]
            e["mean_rel_vs_base_path"] = mean_rel(logits["kernel"][what],
                                                  base["kernel"][what])
            e["mean_rel_vs_base_path_f32"] = mean_rel(logits["f32"][what],
                                                      base["f32"][what])
            e["base_path_bf16_vs_f32_mean_rel"] = mean_rel(
                base["kernel"][what], base["f32"][what])
        errs[what] = e
    windows = window_control(cfg, params, batch_in, max_seq, logits, errs)
    kept = {name: logits[name] for name in ("kernel", "f32")}
    del logits, models
    first = None
    if cfg.family in ("ssm", "hybrid"):
        first = first_layer_vs_plain(cfg, model, params, batch_in)
    elif cfg.family in ("moe", "encdec", "vlm") or cfg.weight_quant != "none":
        first = first_attention_vs_plain(cfg, model, params, batch_in)
    if cfg.mla is not None:
        first.update(first_latent_decode_vs_plain(cfg, model, params,
                                                  batch_in, max_seq))

    checks_peak = torch.cuda.max_memory_allocated()   # the f32 models' too
    ref_eng = ServeEngine(ref_cfg, batch=batch, max_seq=max_seq,
                          prefill_len=prefill_len, instrument=False)
    with buffer_path():
        ref_stats = ref_eng.run(params, requests())
    same = total = 0
    for r in ref_eng.done:
        out = outputs[r.req_id]
        total += max(len(out), len(r.output))
        same += sum(a == b for a, b in zip(out, r.output))
    emit("serve_vs_plain", arch=path, logits_max_abs_err=errs,
         greedy_tokens_agree=same / max(total, 1), tokens_compared=total,
         first_layer=first, window_control=windows,
         checks_peak_memory_bytes=checks_peak, plain_path_stats=ref_stats)
    return eng, launches, params, kept


def window_control(cfg, params, batch_in, max_seq, logits, errs):
    """On a path with windowed layers, the control that must fail: the same
    prefill and decode step on the kernel path with every window set to -1
    (every layer global) must move the logits past the path's limit, or the
    kernels would not be shown to mask the keys below the window.  None on
    a path without windows."""
    from repro_torch.models.model_zoo import build_model
    if all(w < 0 for w in cfg.layer_windows()):
        return None
    glob = build_model(dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, local_window=0)))
    assert all(w < 0 for w in glob.cfg.layer_windows())
    moved = path_logits({"kernel": glob}, params, batch_in, max_seq)[0]
    out = {"windows": sorted(set(cfg.layer_windows())),
           "prompt_len": int(batch_in["tokens"].shape[1])}
    for what in ("prefill_logits", "decode_logits"):
        d = (moved["kernel"][what] - logits["kernel"][what]).abs().max().item()
        assert d > errs[what]["limit"], (what, d, errs[what]["limit"])
        out[what] = {"global_vs_windowed": d, "limit": errs[what]["limit"]}
    return out


def mean_rel(a, b) -> float:
    """mean |a - b| / mean |b|, the reference's measure for int8 weights
    (tests/test_perf_features.py)."""
    return ((a - b).abs().mean() / b.abs().mean()).item()


# the compared pairs of paths: (kernel or plain) x (bf16 or f32 activations)
PAIRS = {"kernel_vs_plain": ("kernel", "plain"),
         "kernel_vs_f32": ("kernel", "f32"),
         "plain_vs_f32": ("plain", "f32"),
         "f32_kernel_vs_plain": ("kernel_f32", "f32")}


def path_logits(models, params, batch_in, max_seq, on_buffer=()):
    """Each model's prefill logits of `batch_in` and those of one decode
    step after it, with the expert choices of every MoE layer; the models
    named in ``on_buffer`` run with the grouped route closed."""
    logits, routes = {}, {}
    for name, m in models.items():
        with buffer_path() if name in on_buffer else contextlib.nullcontext():
            logits[name], routes[name] = _one_path(m, params, batch_in,
                                                   max_seq)
    return logits, routes


def _one_path(m, params, batch_in, max_seq):
    """One model's (logits, expert choices) of the prefill and one decode
    step, for `path_logits`."""
    cache = m.init_cache(2, max_seq)
    with RoutingSpy() as pre_spy:
        pre = m.prefill(params, batch_in, cache)[0].float()
    tok = torch.full((2, 1), 17, dtype=torch.int32,
                     device=batch_in["tokens"].device)
    with RoutingSpy() as dec_spy:
        dec = m.decode_step(params, tok, cache)[0].float()
    del cache
    return ({"prefill_logits": pre, "decode_logits": dec},
            {"prefill_logits": pre_spy.choices,
             "decode_logits": dec_spy.choices})


def logit_errs(logits, what) -> dict:
    """The largest difference of each pair of `PAIRS` whose paths ran."""
    e = {pair: (logits[a][what] - logits[b][what]).abs().max().item()
         for pair, (a, b) in PAIRS.items() if a in logits and b in logits}
    e["logits_abs_max"] = logits["f32"][what].abs().max().item()
    return e


class RoutingSpy:
    """Records the expert choice of every MoE layer a call runs: the top-k
    expert ids that `models.moe.route` returns ([B, S, k] each), in call
    order.  `moe_mlp` looks `route` up in its module on every call."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real, self.choices = moe, moe.route, []

        def route(*a, **kw):
            out = self.real(*a, **kw)
            self.choices.append(out[0].detach())
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real


def routing_differs(a, b, by_layer: bool = False):
    """Share of the (token, layer) routing decisions in which two runs chose
    another set of experts (`by_layer`: the share in each layer)."""
    if not a:
        return [] if by_layer else 0.0
    assert len(a) == len(b), (len(a), len(b))
    diff = torch.stack([
        (x.sort(-1).values != y.sort(-1).values).any(-1).float().mean()
        for x, y in zip(a, b)])
    return diff.tolist() if by_layer else diff.mean().item()


def first_attention_vs_plain(cfg, model, params, batch_in) -> dict:
    """The first attention block of the prompt (norm, projections, rope,
    attention, output projection) through K1 (`attention_impl="cuda"`) and
    through the plain attention, in bf16 from the same embedding: held to
    2e-2 of its largest magnitude (a few bf16 steps), as the SSM paths'
    first block.  One layer deep, a random-weight stack's amplification of
    rounding (see `phase_serve`) cannot hide a fault of the kernel.  For the
    enc-dec family it is the encoder's first block (layer norm, projections,
    K1 not causal over the frames, output projection); for the VLM the
    embedding holds the projected patches.  With int4 weights the plain
    side runs on the same weights unpacked to bf16 (`_unpacked`), so the
    unpacking on use is held too."""
    from repro_torch.configs.base import dtype_of
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_index
    out = {}
    if cfg.family == "encdec":
        dt = dtype_of(cfg.compute_dtype)
        p = tree_index(params["enc_layers"], 0)
        x = batch_in["frames"].to(dt) + params["enc_pos"].to(dt)[None]
        h = ED.layernorm(p["attn_norm"], x)
        pos = T.positions_for(x[..., 0])
        for impl in ("cuda", "reference"):
            c = dataclasses.replace(cfg, attention_impl=impl)
            out[impl] = ED._self_attn(p["attn"], c, model.dims, h, pos,
                                      causal=False, dt=dt)[0].float()
    else:
        p = T.layer_params(params, cfg, 0)
        x = T.embed_tokens(params, cfg, model.dims, batch_in["tokens"],
                           batch_in.get("patches"))
        pos = T.positions_for(batch_in["tokens"])
        for impl in ("cuda", "reference"):
            c, pi = dataclasses.replace(cfg, attention_impl=impl), p
            if impl == "reference" and cfg.weight_quant == "int4":
                # the plain path on the same weights unpacked to bf16
                pi = _unpacked(p, dtype_of(cfg.compute_dtype))
                c = dataclasses.replace(c, weight_quant="none")
            out[impl] = T._attn_block(pi, c, model.dims, x, pos, -1,
                                      plus_one=False, aux={})[0].float()
    g, w = out["cuda"], out["reference"]
    assert bool(torch.isfinite(g).all())
    scale = w.abs().max().item()
    rel = (g - w).abs().max().item() / max(scale, 1e-30)
    assert rel <= 2e-2, rel
    return {"attn_block_out": {"max_rel_err": rel, "scale": scale,
                               "limit": 2e-2}}


def first_latent_decode_vs_plain(cfg, model, params, batch_in,
                                 max_seq) -> dict:
    """The first layer's latent attention in one decode step after the
    checks' prefill (norm, projections, the latent written at each row's
    length, the absorbed attention, the output projection) through the
    latent-decode kernel (`attention_impl="cuda"`) and through its plain
    version, in bf16 on copies of the same cache: held to 2e-2 of its
    largest magnitude, as the prefill's attention block."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    cache = model.init_cache(2, max_seq)
    model.prefill(params, batch_in, cache)
    lengths = cache["length"]
    tok = torch.full((2, 1), 17, dtype=torch.int32, device="cuda")
    x = T.embed_tokens(params, cfg, model.dims, tok)
    rope = T.rope_tables(cfg, lengths[:, None])
    p = T.layer_params(params, cfg, 0)
    out = {}
    for impl in ("cuda", "reference"):
        lat = cache["latent"][0].clone()
        out[impl] = D._mla_decode_attn(
            p, dataclasses.replace(cfg, attention_impl=impl), x, rope, lat,
            lengths, lengths + 1, D._write_index(lengths, lat)).float()
    del cache
    g, w = out["cuda"], out["reference"]
    assert bool(torch.isfinite(g).all())
    scale = w.abs().max().item()
    rel = (g - w).abs().max().item() / max(scale, 1e-30)
    assert rel <= 2e-2, rel
    return {"latent_decode_out": {"max_rel_err": rel, "scale": scale,
                                  "limit": 2e-2,
                                  "lengths": lengths.tolist()}}


def first_layer_vs_plain(cfg, model, params, batch_in) -> dict:
    """The first Mamba2 layer of the prompt through K3 (`ssm_impl="cuda"`)
    and through `ssd_chunked`, from the same bf16 projections.  A stack of
    random-weight Mamba2 layers amplifies rounding differences from layer to
    layer (bf16 activations move its logits by about half their size), so
    the whole-model rule above can only bound the kernel path loosely; one
    layer cannot hide a fault.  The SSD output and final state are f32 from
    the same inputs: held to K3's relative limit for these inputs
    (`ssd_limit`).  The block output is bf16: held to 2e-2 of its largest
    magnitude (a few bf16 steps)."""
    from repro_torch.kernels.ssd import ssd_intra_plain
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    p = T.layer_params(params, cfg, 0)
    x = T.embed_tokens(params, cfg, model.dims, batch_in["tokens"])
    h = L.rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
    _, xh, Bp, Cp, dt, _ = S._project(p["ssm"], cfg, h, h.dtype)
    A = S.a_of(p["ssm"])
    out = {}
    got = S.ssd("cuda", xh, dt, A, Bp, Cp, cfg.ssm.chunk)
    want = S.ssd("chunked", xh, dt, A, Bp, Cp, cfg.ssm.chunk)
    blocks = [S.mamba2_block(p["ssm"], cfg, h, impl=impl)
              for impl in ("cuda", "chunked")]
    lim = ssd_limit(ssd_intra_plain(xh, dt, A, Bp, Cp, cfg.ssm.chunk)[3])
    for name, g, w, limit in (("ssd_y", got[0], want[0], lim),
                              ("ssd_h_final", got[1], want[1], lim),
                              ("block_out", *blocks, 2e-2)):
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), name
        scale = w.abs().max().item()
        rel = (g - w).abs().max().item() / max(scale, 1e-30)
        assert rel <= limit, (name, rel, limit)
        out[name] = {"max_rel_err": rel, "scale": scale, "limit": limit}
    return out


def is_device_work(e) -> bool:
    """A profiler row of device work: a kernel, copy or fill, not a
    device-side span of a `record_function` range (the block labels,
    `models/layers.scope`, show on the device's timeline too, over the
    kernels they enclose)."""
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA and \
        not getattr(e, "is_user_annotation", False)


def phase_trace(path, eng, params, prefill_len: int, steps: int = 5) -> None:
    """Optional (`--phases ...,trace`): where a decode step's and a prefill's
    time goes.  Host time per call (host clock around calls that end in a
    synchronise), device-busy time (sum of kernel times from torch.profiler)
    and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    model = eng.model
    tok = torch.zeros((eng.batch, 1), dtype=torch.int32, device="cuda")
    toks = torch.zeros((1, prefill_len), dtype=torch.int64, device="cuda")
    pre_cache = model.init_cache(1, eng.max_seq)

    def decode():
        eng.cache["length"].fill_(prefill_len + 40)
        model.decode_step(params, tok, eng.cache)

    def prefill():
        model.prefill(params, {"tokens": toks, **eng.stub_inputs}, pre_cache)

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
                if is_device_work(e)]
        busy_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        out[name] = {
            "host_ms": host_ms, "device_busy_ms": busy_ms,
            # the port's own kernels (K1, K2, K3, the grouped MoE, the
            # latent decode) by name
            "port_kernels": {k[:60]: {"ms": ms, "calls": n}
                             for k, ms, n in rows
                             if "flash_" in k or "ssd_" in k
                             or "moe_grouped" in k or "mla_decode" in k},
            "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:70], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}
    emit("trace", arch=path, steps=steps, **out)


BLOCKS = {"dense": ("attn", "mlp"), "moe": ("attn", "moe", "dropped_tokens"),
          "ssm": ("mamba",), "hybrid": ("mamba", "shared_attn"),
          "vlm": ("attn", "mlp"), "encdec": ("enc_layer", "dec_layer")}


def phase_profile(path, eng) -> None:
    """The interval profile of the serving run.  For the SSM families also
    the traced FLOPs of a prefill's mamba block through the kernel path
    (`ssm_impl="cuda"`) over those through `ssd_chunked`, which the
    reference's table traces."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.models.model_zoo import build_model
    prof = eng.profile()
    names = prof.table.names
    assert prof.n_intervals >= 1
    # a MoE stack led by dense layers has their mlp block too
    blocks = BLOCKS[eng.cfg.family] + (("mlp",) if eng.cfg.n_dense_layers
                                       else ())
    for kind in ("prefill", "decode"):
        for block in blocks:
            assert f"{kind}/{block}" in names, (kind, block, names)
    extra = {}
    if eng.cfg.family in ("ssm", "hybrid"):
        shape = ShapeConfig("p", "prefill", eng.prefill_len, 1)
        flops = {}
        for impl in ("cuda", "chunked"):
            tab = build_block_table(
                build_model(dataclasses.replace(eng.cfg, ssm_impl=impl)),
                shape, train=False, unit="flops")
            flops[impl] = tab.blocks[tab.id_of("mamba")].cost_flops
        extra["mamba_prefill_traced_flops"] = flops
        extra["mamba_flops_ratio_cuda_vs_chunked"] = \
            flops["cuda"] / flops["chunked"]
    emit("profile", arch=path, n_intervals=prof.n_intervals,
         blocks=list(names), **extra)


# The model-accuracy study of the paper's §V-B: the loss forward of three
# architectures (bf16, default impls, batch 2 x 512), its ATen graph on meta
# tensors against the kernels one call runs on the card.  olmoe-1b-7b runs 4
# of its 16 layers (reduced depth, as its train check).
ACCURACY = (("qwen3-1.7b", None), ("mamba2-780m", None), ("olmoe-1b-7b", 4))
ACCURACY_BATCH, ACCURACY_SEQ = 2, 512
# the block labels of each family, and where K1 and K3 must lie
ACCURACY_LABELS = {"dense": ("nugget_block_attn", "nugget_block_mlp"),
                   "moe": ("nugget_block_attn", "nugget_block_moe"),
                   "ssm": ("nugget_block_mamba",)}


def is_product_kernel(name: str) -> bool:
    """A library matrix product by its normalised kernel name: cuBLAS's
    Hopper kernels (``nvjet_...``), its ``sm90_xmma_gemm_...`` and CUTLASS
    kernels, or any name with ``gemm``."""
    low = name.lower()
    return any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma"))


@contextlib.contextmanager
def labels(on: bool):
    """The block labels as they are (``on``) or replaced by a null context,
    as if the blocks had none."""
    from repro_torch.models import layers as L
    real = L.scope
    if not on:
        L.scope = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        L.scope = real


def _meta_tree(model):
    """Meta tensors for a model's parameters (int4 payloads packed)."""
    from repro_torch.configs.base import dtype_of
    from repro_torch.models import layers as L
    dt = dtype_of(model.cfg.param_dtype)
    return L.map_specs(lambda s: torch.empty(
        L.stored_shape(s), dtype=L.spec_dtype(s) or dt, device="meta"),
        model.specs())


def phase_accuracy() -> dict:
    """The §V-B study on the card, per architecture of `ACCURACY`: the
    portable IR's histogram (`hlo_analysis.ir_histogram`, the ATen graph on
    meta tensors) against the kernels of one warm call under torch.profiler
    (`kernel_histogram_of`), their ratio and largest deltas
    (`histogram_delta`).  Asserts that K1's count in the kernel histogram
    equals its launch counter and the attention layers, K3's the Mamba2
    layers; that `find_scope_labels` places K1 under "nugget_block_attn",
    K3 under "nugget_block_mamba" and a product kernel under the MLP's or
    the MoE's label; and that the labels add no launch: the same forward
    outside a profile, with the labels on and off, launches what the
    profiled one does, and a profile with the labels off holds as many
    kernels.  Each profile holds every device event of its call
    (`profile_call` takes again one that lost some, and says how many it
    took).  The IR takes the kernels' plain versions (a wrapper on a meta
    tensor), the card runs K1 and K3: that delta is kept, as the study is
    there to show it."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import hlo_analysis as H
    from repro_torch.models.model_zoo import build_model
    out = {}
    shape = ShapeConfig("accuracy", "train", ACCURACY_SEQ, ACCURACY_BATCH)
    for arch, depth in ACCURACY:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full if depth is None else dataclasses.replace(full,
                                                             n_layers=depth)
        meta = build_model(cfg, device="meta")
        ir = H.ir_histogram(lambda p, b: meta.loss(p, b)[0], _meta_tree(meta),
                            meta.input_specs(shape))
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (ACCURACY_BATCH,
                                                 ACCURACY_SEQ),
                             generator=torch.Generator(
                                 device="cuda").manual_seed(1),
                             device="cuda", dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}

        @torch.no_grad()
        def loss():
            return model.loss(params, batch)[0]

        value = loss().item()                  # warm: loads every kernel
        assert math.isfinite(value), value
        outside = {}
        for on in (True, False):              # outside a profile
            with labels(on):
                reset_counters()
                loss()
                torch.cuda.synchronize()
                outside[on] = read_counters()
        with labels(False):
            prof_off = H.profile_call(loss)
        # ---- the main path: counters to 0 just before, read just after -----
        reset_counters()
        prof = H.profile_call(loss)
        launches = read_counters()
        kern = H.kernel_histogram_of(prof)
        kern_off = H.kernel_histogram_of(prof_off)

        def count(hist, kernel):
            return sum(hist.get(n, 0) for n in H.PORT_KERNEL_NAMES[kernel])
        n_attn = n_attention_layers(cfg)
        n_ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
        k1, k3 = count(kern, "flash_attention"), count(kern, "ssd_intra")
        assert k1 == launches["flash_attention"] == n_attn, (arch, k1,
                                                              launches)
        assert k3 == launches["ssd_intra"] == n_ssm, (arch, k3, launches)
        assert launches["flash_decode"] == 0 == count(kern, "flash_decode")
        assert outside[True] == outside[False] == launches, (arch, outside)
        assert sum(kern_off.values()) == sum(kern.values()), (
            arch, H.histogram_delta(kern, kern_off)[:6])

        found = {label: H.find_scope_labels(prof, label)
                 for label in ACCURACY_LABELS[cfg.family]}
        in_attn = found.get("nugget_block_attn", [])
        assert sum(n in H.PORT_KERNEL_NAMES["flash_attention"]
                   for n in in_attn) == n_attn, (arch, in_attn[:20])
        if n_ssm:
            assert sum(n in H.PORT_KERNEL_NAMES["ssd_intra"] for n in
                       found["nugget_block_mamba"]) == n_ssm, arch
        for label in ("nugget_block_mlp", "nugget_block_moe"):
            if label in found:
                assert any(is_product_kernel(n) for n in found[label]), (
                    arch, label, sorted(set(found[label]))[:20])

        n_ir, n_k = sum(ir.values()), sum(kern.values())
        deltas = H.histogram_delta(ir, kern)[:6]
        print(f"accuracy {arch}: IR ops {n_ir}, kernels {n_k}, "
              f"ratio {n_ir / n_k:.4f}", flush=True)
        for op, a, b in deltas:
            print(f"accuracy {arch}:   delta {op[:60]} IR {a} kernels {b}",
                  flush=True)
        top = sorted(kern.items(), key=lambda kv: -kv[1])
        raw = {}
        for e in H.device_kernels(prof):
            raw.setdefault(H.kernel_name(e.name), e.name)
        emit("accuracy", arch=arch, n_layers=cfg.n_layers,
             reduced=(None if depth is None else
                      {"n_layers": [full.n_layers, depth]}),
             batch=ACCURACY_BATCH, seq_len=ACCURACY_SEQ,
             compute_dtype=cfg.compute_dtype, loss=value,
             ir_ops=n_ir, kernels=n_k, ratio=n_ir / n_k,
             top_deltas=[list(r) for r in deltas],
             launches=launches, k1_in_histogram=k1, k3_in_histogram=k3,
             kernels_labels_off=sum(kern_off.values()),
             profile_attempts={"labels_off": prof_off.attempts,
                               "labels_on": prof.attempts},
             labels={label: {"ops": len(v), "distinct": len(set(v)),
                             "top": sorted(set(v), key=v.count,
                                           reverse=True)[:4]}
                     for label, v in found.items()},
             top_kernels=top[:12],
             raw_names={k: raw[k] for k, _ in top[:12]
                        if len(raw[k]) <= 600},
             seconds=time.perf_counter() - t0)
        out[f"{arch}/accuracy"] = launches
        del model, params, prof, prof_off
        gc.collect()
        torch.cuda.empty_cache()
    return out


TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 6, 512, 4, 3e-4
GRAD_CHECK_TOL = 2e-4     # chunked vs reference attention, of a leaf's max |grad|


def phase_train(cfg) -> dict:
    """The train path: `Trainer` at full width and depth, bf16, with the
    launcher's AdamW and schedule, `TRAIN_STEPS` steps of `TRAIN_BATCH` x
    `TRAIN_SEQ` tokens on the chunked attention.  Checks finite losses and
    gradient norms, the work meter against the block table, the interval
    profile, that no kernel launched, that a kernel wrapper refuses a tensor
    that requires grad, and that three steps on one batch lower its loss;
    times the steps and traces one under torch.profiler."""
    from repro_torch.core.meter import meter_value
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import constant, linear_warmup_cosine
    from repro_torch.train import Trainer
    from repro_torch.train.state import make_train_step

    cfg = dataclasses.replace(cfg, attention_impl="chunked",
                              ssm_impl="chunked")
    t0 = time.perf_counter()
    tr = Trainer(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                 interval_steps=2.0, instrument=True,
                 opt=AdamWConfig(lr=TRAIN_LR),
                 lr_fn=linear_warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1,
                                            TRAIN_STEPS))
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counters to 0 just before, read just after ---------
    reset_counters()
    state = tr.run(TRAIN_STEPS, state=state)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    assert launches == {k: 0 for k in KERNELS}, launches

    rows = list(tr.metrics_history)
    assert len(rows) == TRAIN_STEPS, rows
    for r in rows:
        assert math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]), r
        assert r["grad_norm"] > 0, r
    table = tr.table
    uow = int(round(table.step_uow()))
    assert meter_value(state.meter) == TRAIN_STEPS * uow
    reading = tr.meter_reading
    assert int(reading["uow"]) == TRAIN_STEPS * uow, reading
    assert reading["steps"] == TRAIN_STEPS, reading
    want_counts = TRAIN_STEPS * table.step_counts()
    assert (reading["counts"] == want_counts).all(), (reading, want_counts)
    prof = tr.profile()
    assert prof.n_intervals >= 2, prof.n_intervals
    step_times = [t * 1e3 for t in tr.step_times]
    step_ms = statistics.median(step_times[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH

    # one step under torch.profiler, after a step timed by the host clock,
    # and its parts apart
    batch0 = tr._device_batch(0)
    trace = train_step_trace(lambda: tr._step_fn(state, batch0))
    trace["parts"] = train_step_parts(tr, state, batch0)

    # the §0 repair on the card: no differentiating through a kernel
    refused = kernels_refuse_grad(cfg, state.params, batch0)

    # three steps on one batch at a constant rate lower its loss
    step = make_train_step(tr.model, tr.opt_cfg, constant(TRAIN_LR),
                           instrument=False)
    losses = []
    for _ in range(3):
        state, m, _ = step(state, batch0)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        losses.append(float(tr.model.loss(state.params, batch0)[0]))
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    del step

    # remat="selective" against "full" on the same state and batch
    selective = selective_vs_full(tr, state, batch0)
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()

    grad = grad_check(cfg)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, seq_len=TRAIN_SEQ,
               batch=TRAIN_BATCH, steps=TRAIN_STEPS,
               table_seconds=table_s, init_seconds=init_s,
               step_ms=step_times,
               median_step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               peak_memory_bytes=peak, losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows],
               step_uow=table.step_uow(), meter_uow=int(reading["uow"]),
               n_intervals=prof.n_intervals, launches=launches,
               one_batch_losses=losses, trace=trace, refused=refused,
               grad_check=grad, selective_vs_full=selective)
    emit("train", **out)
    return launches


SELECTIVE_STEPS = 3


def selective_vs_full(tr, state, batch) -> dict:
    """``remat="selective"`` (the weight products saved, the rest recomputed)
    against ``"full"`` on the train configuration.  First the loss and
    gradients of each on the same state and batch (no update): the losses
    must be equal, and the peak memory above what was allocated before is
    kept.  Then the steps (they update the state), in turns full,
    selective, selective, full: one untimed, then `SELECTIVE_STEPS` timed
    (host clock, each ending in a synchronise), with each turn's peak
    memory.  0 launches of K1, K2 and K3."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.schedule import constant
    from repro_torch.train.state import make_train_step
    steps = {remat: make_train_step(
        build_model(dataclasses.replace(tr.cfg, remat=remat)), tr.opt_cfg,
        constant(TRAIN_LR), instrument=False)
        for remat in ("full", "selective")}
    out = {remat: {"step_ms": []} for remat in steps}
    reset_counters()
    for remat, step in steps.items():
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = step.grads_of(state.params, batch, None)
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        out[remat].update(
            loss=loss.item(), grad_norm=norm.item(),
            loss_and_grad_peak_bytes=torch.cuda.max_memory_allocated() - base)
        del grads, norm
    for remat in ("full", "selective", "selective", "full"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps[remat](state, batch)                 # untimed
        for _ in range(SELECTIVE_STEPS):
            t0 = time.perf_counter()
            steps[remat](state, batch)
            torch.cuda.synchronize()
            out[remat]["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out[remat]["step_peak_bytes"] = max(
            out[remat].get("step_peak_bytes", 0),
            torch.cuda.max_memory_allocated() - base)
        out[remat]["peak_memory_bytes"] = max(
            out[remat].get("peak_memory_bytes", 0),
            torch.cuda.max_memory_allocated())
    assert read_counters() == {k: 0 for k in KERNELS}
    full, sel = out["full"], out["selective"]
    for row in (full, sel):
        row["median_step_ms"] = statistics.median(row["step_ms"])
    assert sel["loss"] == full["loss"], (sel["loss"], full["loss"])
    out["grad_norm_rel_diff"] = abs(sel["grad_norm"] - full["grad_norm"]) / \
        full["grad_norm"]
    assert out["grad_norm_rel_diff"] <= 1e-3, out
    out["step_ms_selective_over_full"] = sel["median_step_ms"] / \
        full["median_step_ms"]
    out["grad_peak_selective_minus_full_bytes"] = \
        sel["loss_and_grad_peak_bytes"] - full["loss_and_grad_peak_bytes"]
    return out


def train_step_trace(fn) -> dict:
    """Host ms of one call (host clock around a call that ends in a
    synchronise), and under torch.profiler its device busy ms (the sum of
    kernel times), idle share and kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if is_device_work(e)]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"host_ms": host_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:70], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]]}


def train_step_parts(tr, state, batch) -> dict:
    """`train_step_trace` of the step's parts: the loss alone (no grad),
    the loss and its gradients (forward, rematerialised forward, backward),
    and the AdamW update."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import adamw_update
    leaves = tree_leaves(state.params)

    def loss():
        with torch.no_grad():
            return tr.model.loss(state.params, batch)[0]

    def grads():
        with torch.enable_grad():
            return torch.autograd.grad(tr.model.loss(state.params, batch)[0],
                                       leaves)

    def like(tree, it):
        return {k: like(v, it) if isinstance(v, dict) else next(it)
                for k, v in tree.items()}

    g = like(state.params, iter(grads()))
    lr = tr.lr_fn(state.step)
    parts = {name: train_step_trace(fn) for name, fn in (
        ("loss_forward", loss), ("loss_and_grad", grads),
        ("adamw_update", lambda: adamw_update(state.params, g, state.opt,
                                              tr.opt_cfg, lr)))}
    for part in parts.values():
        part["top"] = part["top"][:4]
    return parts


def _one_entry():
    """(order, counts, ends) of one token routed to the only expert."""
    return (torch.zeros((1,), dtype=torch.int64, device="cuda"),
            torch.ones((1,), dtype=torch.int32, device="cuda"),
            torch.ones((1,), dtype=torch.int32, device="cuda"))


def kernels_refuse_grad(cfg, params, batch) -> dict:
    """Each kernel wrapper, given CUDA tensors that require grad under grad
    mode, raises instead of returning an output without a grad_fn; so does
    `Model.loss` on `attention_impl="cuda"`.  None of them launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.moe_grouped import grouped_mlp
    from repro_torch.kernels.ssd import ssd_intra
    from repro_torch.models.model_zoo import build_model

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device="cuda", dtype=dtype
                           ).requires_grad_()

    q, k = leaf(1, 64, 4, 64), leaf(1, 64, 4, 64)
    lengths = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": lambda: flash_attention(q, k, k, group=1),
        "flash_decode": lambda: flash_decode(q[:, :1], k, k, lengths, group=1),
        "ssd_intra": lambda: ssd_intra(
            q, leaf(1, 64, 4, dtype=torch.float32),
            leaf(4, dtype=torch.float32), leaf(1, 64, 16), leaf(1, 64, 16),
            64),
        "grouped_mlp": lambda: grouped_mlp(
            leaf(1, 64), leaf(1, 64, 64), leaf(1, 64, 64), leaf(1, 64, 64),
            *_one_entry(), top_k=1),
        "mla_decode": lambda: mla_decode(leaf(1, 16, 576), leaf(1, 64, 576),
                                         lengths, scale=1.0),
        "model_loss_cuda": lambda: build_model(dataclasses.replace(
            cfg, attention_impl="cuda")).loss(params, batch),
    }
    before = read_counters()
    out = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert "chunked" in str(e), (name, e)
            out[name] = str(e)[:80]
        else:
            raise AssertionError(f"{name} ran under grad on a tensor that "
                                 "requires grad")
    assert read_counters() == before
    return out


def grad_check(cfg) -> dict:
    """Full width, 2 layers, f32 params and compute, one batch of 2 x 256:
    the gradients of every leaf through `attention_impl="chunked"` (kv
    chunks of 128, so the streaming softmax carries across chunks) against
    `"reference"` (the quadratic softmax), within GRAD_CHECK_TOL of the
    leaf's largest gradient."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    small = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                compute_dtype="float32", attn_chunk=128)
    models = {impl: build_model(dataclasses.replace(small, attention_impl=impl))
              for impl in ("chunked", "reference")}
    params = models["chunked"].init(torch.Generator().manual_seed(0))
    leaves = L.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    b = SyntheticCorpus(cfg.vocab_size, 256, 2, seed=0).batch_at(0)
    dev = models["chunked"].device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()
             if k != "domains"}
    grads, losses = {}, {}
    for impl, m in models.items():
        loss = m.loss(params, batch)[0]
        grads[impl] = torch.autograd.grad(loss, leaves)
        losses[impl] = loss.item()
    worst = 0.0
    for gc_, gr in zip(grads["chunked"], grads["reference"]):
        scale = gr.abs().max().item()
        err = (gc_ - gr).abs().max().item()
        assert math.isfinite(err) and err <= GRAD_CHECK_TOL * scale, \
            (err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return {"n_leaves": len(leaves), "worst_err_of_scale": worst,
            "limit": GRAD_CHECK_TOL, "loss_chunked": losses["chunked"],
            "loss_reference": losses["reference"]}


# The MoE train check: olmoe-1b-7b at its full width, cut to 4 of its 16
# layers (a full-depth train state, at 14 bytes a parameter, is 96.9 GB, more
# than the card holds), on the phased corpus.
MOE_TRAIN = dict(arch="olmoe-1b-7b", n_layers=4, steps=16, seq_len=256,
                 batch=4, interval_steps=2.0)


def phase_train_moe() -> dict:
    """`Trainer` on olmoe-1b-7b at full width with 4 layers (reduced depth),
    bf16, remat, AdamW, the phased `SyntheticCorpus`, `MOE_TRAIN`.  Checks
    finite losses and gradient norms, the router's auxiliary loss in the
    loss, every step's expert token counts (tokens x top_k x layers), the
    meter (steps x the table's counts plus the dynamic entries), non-zero
    expert columns in the interval profile, and 0 launches of K1, K2, K3.
    Reports step ms, tokens/s, peak memory, the spread of the expert shares
    over the intervals (`tests/test_system.py`'s quantity) and the k that
    `KMeansSelector` chooses."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import KMeansSelector
    from repro_torch.models.model_zoo import cross_entropy
    from repro_torch.models.transformer import lm_forward
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train import Trainer

    r = MOE_TRAIN
    full = get_config(r["arch"])
    cfg = dataclasses.replace(full, n_layers=r["n_layers"],
                              attention_impl="chunked", ssm_impl="chunked")
    steps = r["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = Trainer(cfg, seq_len=r["seq_len"], batch=r["batch"],
                 interval_steps=r["interval_steps"], instrument=True,
                 opt=AdamWConfig(lr=TRAIN_LR),
                 lr_fn=linear_warmup_cosine(TRAIN_LR, steps // 10 + 1, steps))
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counters to 0 just before, read just after ---------
    reset_counters()
    state = tr.run(steps, state=state)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    assert launches == {k: 0 for k in KERNELS}, launches

    rows = list(tr.metrics_history)
    assert len(rows) == steps, rows
    for row in rows:
        assert math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])
        assert row["grad_norm"] > 0, row
    m = cfg.moe
    per_step = r["batch"] * r["seq_len"] * m.top_k * cfg.n_layers
    log = tr.builder.step_log
    tokens = [dyn["expert_tokens"] for _, dyn in log]
    dropped = [int(dyn["dropped_tokens"]) for _, dyn in log]
    for t in tokens:
        assert isinstance(t, np.ndarray) and int(t.sum()) == per_step, t
    table = tr.table
    virt = table.virtual_ids()
    want = steps * table.step_counts()
    want[virt[:-1]] += np.sum(tokens, axis=0).astype(want.dtype)
    want[virt[-1]] += sum(dropped)
    reading = tr.meter_reading
    assert reading["steps"] == steps, reading
    assert int(reading["uow"]) == steps * int(round(table.step_uow()))
    assert (reading["counts"] == want).all(), (reading["counts"], want)

    prof = tr.profile()
    bbv = prof.bbv_matrix()
    experts = bbv[:, virt[:-1]]
    assert prof.n_intervals == int(steps / r["interval_steps"])
    assert (experts.sum(axis=1) > 0).all(), experts
    shares = experts / np.maximum(experts.sum(1, keepdims=True), 1)
    spread = shares.max(0) - shares.min(0)
    assert spread.max() > 0, spread
    sel = KMeansSelector(seed=0).select(prof)

    # the router's loss is in the loss: loss - CE = router_aux_loss / layers
    batch0 = tr._device_batch(0)
    with torch.no_grad():
        loss, aux = tr.model.loss(state.params, batch0)
        logits, _ = lm_forward(state.params, cfg, tr.model.dims,
                               batch0["tokens"])
        ce = cross_entropy(logits, batch0["labels"], cfg.vocab_size)[0]
    router = aux["router_aux_loss"].item() / cfg.n_layers
    assert router > 0, router
    assert abs(loss.item() - ce.item() - router) <= 1e-4 * max(1.0, router), \
        (loss.item(), ce.item(), router)
    n_params = tr.model.param_count(state.params)
    step_times = [t * 1e3 for t in tr.step_times]
    step_ms = statistics.median(step_times[1:])
    out = dict(arch=cfg.name, n_layers=cfg.n_layers,
               reduced={"n_layers": [full.n_layers, cfg.n_layers]},
               params=n_params, seq_len=r["seq_len"], batch=r["batch"],
               steps=steps, interval_steps=r["interval_steps"],
               table_seconds=table_s, init_seconds=init_s,
               step_ms=step_times, median_step_ms=step_ms,
               tokens_per_s=r["batch"] * r["seq_len"] / step_ms * 1e3,
               peak_memory_bytes=peak, losses=[x["loss"] for x in rows],
               grad_norms=[x["grad_norm"] for x in rows],
               router_aux_over_layers=router, loss_minus_ce=loss.item() -
               ce.item(), expert_tokens_per_step=per_step,
               dropped_tokens=dropped, n_intervals=prof.n_intervals,
               expert_share_spread_max=float(spread.max()),
               expert_share_spread=spread.tolist(),
               kmeans_k=len(sel.interval_ids),
               kmeans_intervals=list(sel.interval_ids), launches=launches)
    emit("train_moe", **out)
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

# (arch, prefill_len): every path at full width and depth, bf16, random
# The pipeline path: the command of the README, through `Pipeline` itself.
PIPE_RUN = dict(steps=16, seq_len=256, batch=4, interval_steps=2.0)


def _stage_names(platforms) -> list:
    names = ["profile", "select", "mark"]
    names += [f"baseline@{p}" for p in platforms]
    names += [f"replay@{p}" for p in platforms]
    return names + ["validate"]


class _TrainerSpy:
    """Counts the `Trainer`s a pipeline run builds and times each
    `init_state` (every `runner.reset` draws a whole train state), by
    standing in for `repro_torch.train.Trainer`, which `PipelineContext`
    imports when it builds one."""

    def __init__(self):
        import repro_torch.train as train_pkg
        self.pkg, self.real = train_pkg, train_pkg.Trainer
        self.built, self.init_s = [], []
        spy = self

        class Trainer(self.real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                spy.built.append(self)

            def init_state(self):
                t0 = time.perf_counter()
                state = super().init_state()
                torch.cuda.synchronize()
                spy.init_s.append(time.perf_counter() - t0)
                return state

        self.cls = Trainer

    def __enter__(self):
        self.pkg.Trainer = self.cls
        return self

    def __exit__(self, *exc):
        self.pkg.Trainer = self.real


def _hits(manifest) -> dict:
    return {s["stage"]: s["cache_hit"] for s in manifest["stages"]}


def _run_pipeline(cfg, store) -> tuple:
    """One `Pipeline.run` with a fresh spy: (manifest, spy, peak bytes)."""
    from repro_torch.pipeline import Pipeline
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _TrainerSpy() as spy:
        manifest = Pipeline(cfg, store).run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return manifest, spy, peak


def _check_cold(manifest, platforms, n_intervals) -> None:
    from repro_torch.core.profile_store import load_profile
    names = _stage_names(platforms)
    assert [s["stage"] for s in manifest["stages"]] == names, manifest["stages"]
    assert manifest["cache_misses"] == len(names), _hits(manifest)
    prof = load_profile(os.path.join(manifest["stages"][0]["path"], "profile"))
    assert prof.n_intervals == n_intervals, prof.n_intervals
    m = manifest["metrics"]
    for p in platforms:
        row = m["platforms"][p]
        assert row["actual_s"] > 0 and row["predicted_s"] > 0, row
        assert math.isfinite(row["error"]), row
    assert len(m["speedup_errors"]) == len(platforms) * (len(platforms) - 1) // 2


def _errors(manifest) -> dict:
    m = manifest["metrics"]
    return {"platforms": m["platforms"],
            "speedup_errors": m["speedup_errors"],
            "stage_wall_s": {s["stage"]: s["wall_s"]
                             for s in manifest["stages"]}}


def _peak_without_the_drop(runner) -> int:
    """Peak memory of `measure_full_run` as it was before it dropped its
    throwaway state: the second reset runs while the first state is bound.
    Two steps, which is where that peak falls."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = runner.reset(0)
    state = runner.run_step(state, 0)
    runner.sync(state)
    state = runner.reset(0)
    state = runner.run_step(state, 0)
    runner.sync(state)
    peak = torch.cuda.max_memory_allocated()
    del state
    return peak


def _payload_bytes(path) -> dict:
    """Every payload file's bytes; an `.npz` by its members' bytes, since
    its zip headers hold the time it was written."""
    import zipfile
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            if f == "spec.json":           # provenance: key, upstream, hashes
                continue
            full = os.path.join(d, f)
            rel = os.path.relpath(full, path)
            if f.endswith(".npz"):
                with zipfile.ZipFile(full) as z:
                    for name in z.namelist():
                        out[f"{rel}/{name}"] = z.read(name)
            else:
                with open(full, "rb") as fh:
                    out[rel] = fh.read()
    return out


def pipeline_parallel_equals_serial(tmp) -> dict:
    """`workers=4` against the serial run at the reduced size on the card:
    the same stage keys, profile payload bytes, selection and nuggets."""
    from repro_torch.pipeline import PipelineConfig
    cfg = PipelineConfig(arch="qwen3-1.7b", platforms=("f32", "bf16"),
                         selector="kmeans", selector_args={"seed": 0},
                         steps=8, seq_len=16, batch=2, interval_steps=2.0,
                         reduce=True, device="cuda")
    runs = {}
    for workers in (0, 4):
        m, _, _ = _run_pipeline(dataclasses.replace(cfg, workers=workers),
                                os.path.join(tmp, f"reduced-w{workers}"))
        assert m["cache_misses"] == len(m["stages"]), _hits(m)
        runs[workers] = {s["stage"]: s for s in m["stages"]}
    serial, par = runs[0], runs[4]
    assert {k: s["key"] for k, s in serial.items()} == \
        {k: s["key"] for k, s in par.items()}
    for stage in ("profile", "select", "mark"):
        a, b = _payload_bytes(serial[stage]["path"]), \
            _payload_bytes(par[stage]["path"])
        assert a and a == b, f"{stage} payload differs"
    return {"stages": len(serial), "equal": True}


def phase_pipeline(tmp) -> dict:
    """The pipeline path: `Pipeline` (profile -> select -> mark -> baseline
    -> replay -> validate) on full-width qwen3-1.7b, platforms bf16 and f32,
    `PIPE_RUN`, k-means, in a fresh store: every stage computes, and the
    profile has steps / interval_steps intervals.  Then a warm rerun (every
    stage hits and no `Trainer` is built), a selector change (profile and
    baselines hit; select, mark, replays and validate re-run), full-width
    mamba2-780m on bf16 (cold), and `workers=4` against serial at the reduced
    size.  K1, K2 and K3 must launch 0 times: the pipeline trains on the
    chunked attention and SSD, as the JAX package's does."""
    from repro_torch.pipeline import PipelineConfig
    from repro_torch.train import Trainer

    plats = ("bf16", "f32")
    cfg = PipelineConfig(arch="qwen3-1.7b", platforms=plats,
                         selector="kmeans", selector_args={"seed": 0},
                         reduce=False, device="cuda", **PIPE_RUN)
    store = os.path.join(tmp, "store")
    n_int = int(PIPE_RUN["steps"] / PIPE_RUN["interval_steps"])
    t_phase = time.perf_counter()
    launches = {}
    # ---- the main path: counters to 0 just before, read just after ---------
    reset_counters()
    cold, spy, peak = _run_pipeline(cfg, store)
    _check_cold(cold, plats, n_int)
    assert len(spy.built) == len(plats), len(spy.built)
    init_s = list(spy.init_s)
    profile_tr = spy.built[0]
    step_ms = [t * 1e3 for t in profile_tr.step_times]

    warm, spy_w, _ = _run_pipeline(cfg, store)
    assert all(_hits(warm).values()), _hits(warm)
    assert spy_w.built == [] and spy_w.init_s == [], len(spy_w.built)
    warm_built = len(spy_w.built)
    assert [s["key"] for s in warm["stages"]] == \
        [s["key"] for s in cold["stages"]]
    assert warm["metrics"] == cold["metrics"]

    sel = dataclasses.replace(cfg, selector="random",
                              selector_args={"n_samples": 2, "seed": 0})
    changed, spy_s, _ = _run_pipeline(sel, store)
    h = _hits(changed)
    want = {name: name in ("profile", "baseline@bf16", "baseline@f32")
            for name in _stage_names(plats)}
    assert h == want, h
    launches[cfg.arch] = read_counters()

    ssm_cfg = dataclasses.replace(cfg, arch="mamba2-780m", platforms=("bf16",))
    reset_counters()
    ssm, spy_m, ssm_peak = _run_pipeline(ssm_cfg, os.path.join(tmp, "ssm"))
    launches[ssm_cfg.arch] = read_counters()
    _check_cold(ssm, ("bf16",), n_int)
    ssm_tr = spy_m.built[0]
    ssm_step_ms = [t * 1e3 for t in ssm_tr.step_times]
    ssm_init_s = list(spy_m.init_s)
    for arch, n in launches.items():
        assert n == {k: 0 for k in KERNELS}, (arch, n)
    del spy, spy_w, spy_s, spy_m, profile_tr, ssm_tr
    main_path_s = time.perf_counter() - t_phase

    # the peak that `measure_full_run` had before it dropped its throwaway
    # state, on the f32 platform (f32 activations): the cold run's peak is
    # the phase's with the drop, the larger of the two the phase's without
    tr = Trainer(cfg.arch_for("f32"), seq_len=cfg.seq_len, batch=cfg.batch,
                 seed=cfg.seed, instrument=False, device="cuda")
    peak_old = _peak_without_the_drop(tr.make_runner())
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    out = dict(
        arch=cfg.arch, platforms=list(plats), **PIPE_RUN,
        n_intervals=n_int, stages=len(cold["stages"]),
        cold=_errors(cold), cold_wall_s=cold["wall_s"],
        warm_wall_s=warm["wall_s"], warm_trainers_built=warm_built,
        selector_change={"hits": h, "wall_s": changed["wall_s"],
                         **_errors(changed)},
        nuggets_kmeans=len(cold["metrics"]["nugget_variability"]),
        init_state_s=init_s, profile_step_ms=step_ms,
        median_step_ms=statistics.median(step_ms[1:]),
        peak_memory_bytes=peak,
        peak_memory_bytes_without_the_drop=max(peak, peak_old),
        full_run_peak_bytes_without_the_drop={"f32": peak_old},
        mamba2={"arch": ssm_cfg.arch, **_errors(ssm), "wall_s": ssm["wall_s"],
                "init_state_s": ssm_init_s,
                "step_ms": ssm_step_ms,
                "median_step_ms": statistics.median(ssm_step_ms[1:]),
                "peak_memory_bytes": ssm_peak},
        launches=launches, main_path_s=main_path_s,
        seconds=time.perf_counter() - t_phase)
    emit("pipeline", **out)

    t0 = time.perf_counter()
    reset_counters()
    parallel = pipeline_parallel_equals_serial(tmp)
    assert read_counters() == {k: 0 for k in KERNELS}, read_counters()
    emit("pipeline_parallel", **parallel, seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# the distributed phase: NCCL at world size 1, the sharded train step
# ---------------------------------------------------------------------------

DIST_STEPS = 3
DIST_LOSS_TOL = 2e-2      # relative; tests/test_sharded_train.py's bound
# The fault-injected run (tests/test_fault_tolerance.py's): reduced qwen3 on
# the card, killed at steps 7 and 13, a checkpoint every 5 steps.  A
# full-width train state is 24 GB a checkpoint.
FAULT_RUN = dict(steps=16, seq_len=16, batch=2, ckpt_every=5,
                 kill_at={1: 7, 2: 13})


def _timed_steps(step, state, batches) -> tuple:
    """Run ``step`` over ``batches``; (state, losses, host ms per step: a
    host clock around each step, which ends in a synchronise)."""
    losses, host_ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m, _ = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, host_ms


def phase_distributed(tmp) -> dict:
    """The distributed modules on the card, through an NCCL process group of
    world size 1 (`launch.mesh.init_process_group`, a `file://` store; a
    failing NCCL start fails the phase, there is no gloo fallback) and a
    `(data 1, model 1)` DeviceMesh.  The sharded train step (qwen3-1.7b at
    full width and depth, bf16, remat, 4 x 512, AdamW with the f32 master,
    chunked attention; parameters, moments and master DTensors placed by
    `params_shardings` and `opt_state_axes`, the batch sharded over "batch")
    against the plain step from the same parameters: losses within
    `DIST_LOSS_TOL`, the same block table and unit of work, K1/K2/K3 at 0
    launches; host ms, device busy ms and peak memory of both.  Then
    `compressed_psum` of a gradient tree over NCCL (each leaf within its
    int8 half step), `meter_psum`, an elastic restore of the plain
    parameters onto the mesh (bit-equal), `gpipe` at S = 1 against
    sequential apply, the fault-injected training run at the reduced size
    (bit-equal to the uninterrupted run), and every kernel wrapper refusing
    a CUDA DTensor."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.core.meter import meter_psum
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.distributed.sharding import (
        distribute, distribute_batch, logical_rules, params_shardings,
        sharded_region, to_plain, use_rules)
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import (AdamWConfig, compressed_psum,
                                   compression_ratio, constant,
                                   init_error_feedback)
    from repro_torch.train.state import init_train_state, make_train_step

    t_phase = time.perf_counter()
    backend = init_process_group(os.path.join(tmp, "nccl_store"), 0, 1,
                                 timeout_s=300)
    assert backend == "nccl" and dist.get_backend() == "nccl", backend
    out = {"backend": backend, "world_size": dist.get_world_size()}
    try:
        mesh = make_host_mesh(model=1)
        assert mesh.device_type == "cuda", mesh
        plan = logical_rules(mesh, mode="train")
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  attention_impl="chunked",
                                  ssm_impl="chunked")
        shape = ShapeConfig("dist_train", "train", TRAIN_SEQ, TRAIN_BATCH)
        opt = AdamWConfig(lr=TRAIN_LR)
        corpus = SyntheticCorpus(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                 seed=0)
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in corpus.batch_at(i).items()
                    if k in ("tokens", "labels")}
                   for i in range(DIST_STEPS)]

        # ---- the plain step ----------------------------------------------
        model1 = build_model(cfg)
        table1 = build_block_table(model1, shape)
        t0 = time.perf_counter()
        p0 = model1.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        out["init_seconds"] = time.perf_counter() - t0
        state = init_train_state(model1, tree_map(lambda t: t.clone(), p0),
                                 opt, table1)
        step1 = make_train_step(model1, opt, constant(TRAIN_LR), table=table1)
        torch.cuda.reset_peak_memory_stats()
        state, plain_losses, plain_ms = _timed_steps(step1, state, batches)
        plain_trace = train_step_trace(lambda: step1(state, batches[0]))
        plain_peak = torch.cuda.max_memory_allocated()
        plain_kernels = step_kernels(lambda: step1(state, batches[0]))
        # kept in host memory, so that the two runs' peaks compare
        plain_params = tree_map(lambda t: t.detach().to("cpu", copy=True),
                                state.params)
        ck_dir = os.path.join(tmp, "dist_ck")
        t0 = time.perf_counter()
        Checkpointer(ck_dir, async_save=False).save(
            DIST_STEPS, {"params": state.params})
        save_s = time.perf_counter() - t0
        del state, step1
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the sharded step: counters to 0 just before, read just after -
        with use_rules(plan):
            model2 = build_model(cfg, plan)
            table2 = build_block_table(model2, shape)
            axes = model2.axes()
            params = distribute(tree_map(lambda t: t.clone(), p0),
                                params_shardings(mesh, plan, axes))
            state = init_train_state(model2, params, opt, table2)
            sbatches = [distribute_batch(b, plan) for b in batches]
            step2 = make_train_step(model2, opt, constant(TRAIN_LR),
                                    table=table2)
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            state, sharded_losses, sharded_ms = _timed_steps(
                step2, state, sbatches)
            launches = read_counters()
            assert launches == {k: 0 for k in KERNELS}, launches
            sharded_trace = train_step_trace(
                lambda: step2(state, sbatches[0]))
            sharded_peak = torch.cuda.max_memory_allocated()
            sharded_kernels = step_kernels(lambda: step2(state, sbatches[0]))
            emit("distributed_kernel_delta", **kernel_delta(plain_kernels,
                                                            sharded_kernels))
            leaf, mu = tree_leaves(state.params)[0], tree_leaves(
                state.opt.mu)[0]
            assert type(leaf).__name__ == "DTensor" and \
                mu.placements == leaf.placements, (type(leaf), mu)
            rel = [abs(a - b) / abs(b)
                   for a, b in zip(sharded_losses, plain_losses)]
            assert all(math.isfinite(x) for x in sharded_losses)
            assert max(rel) < DIST_LOSS_TOL, (plain_losses, sharded_losses)
            assert table1.names == table2.names
            assert table1.step_uow() == table2.step_uow()
            # the timed steps, the trace's two and the profiles' one each
            steps_run = DIST_STEPS + 2 + sharded_kernels["profiles_taken"]
            assert int(state.meter["uow"]) == \
                steps_run * int(round(table2.step_uow()))
            out.update(
                arch=cfg.name, n_layers=cfg.n_layers, seq_len=TRAIN_SEQ,
                batch=TRAIN_BATCH, steps=DIST_STEPS,
                plain_losses=plain_losses, sharded_losses=sharded_losses,
                loss_rel_diff=rel, step_uow=table2.step_uow(),
                same_block_names=True, launches=launches,
                plain_step_host_ms=plain_ms,
                sharded_step_host_ms=sharded_ms,
                plain_trace=plain_trace, sharded_trace=sharded_trace,
                plain_peak_memory_bytes=plain_peak,
                sharded_peak_memory_bytes=sharded_peak)

            # ---- compressed_psum of one gradient tree over NCCL ----------
            with torch.enable_grad(), sharded_region(state.params):
                loss, _ = model2.loss(state.params, sbatches[0])
                grads = torch.autograd.grad(loss, tree_leaves(state.params))
            del loss
            dp = mesh["data"]
            worst, t_c = 0.0, 0.0
            for g in grads:
                g = to_plain(g)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean, _ = compressed_psum({"g": g}, init_error_feedback(
                    {"g": g}), dp)
                torch.cuda.synchronize()
                t_c += time.perf_counter() - t0
                gmax = float(g.float().abs().max())
                half = gmax / 127 / 2
                err = float((mean["g"] - g.float()).abs().max())
                # the half step, and the f32 rounding of q * scale
                assert err <= half + gmax * 2 ** -23, (err, half)
                worst = max(worst, err / half if half else 0.0)
                del mean
            out["compressed_psum"] = dict(
                leaves=len(grads), worst_err_over_half_step=worst,
                ms=t_c * 1e3, compression_ratio=compression_ratio(
                    {str(i): g for i, g in enumerate(grads)}))
            del grads

            # ---- meter_psum over NCCL ------------------------------------
            summed = meter_psum(state.meter, dp)
            assert all(torch.equal(summed[k], state.meter[k])
                       for k in state.meter), (summed, state.meter)
            out["meter_psum"] = {"uow": int(summed["uow"]),
                                 "steps": int(summed["steps"])}
            del state, step2, sbatches
            gc.collect()
            torch.cuda.empty_cache()

            # ---- elastic restore of the plain parameters onto the mesh ---
            t0 = time.perf_counter()
            restored, _ = Checkpointer(ck_dir).restore(
                {"params": p0}, DIST_STEPS,
                shardings={"params": params_shardings(mesh, plan, axes)})
            restore_s = time.perf_counter() - t0
            same = [type(r).__name__ == "DTensor"
                    and torch.equal(to_plain(r).cpu(), p)
                    for r, p in zip(tree_leaves(restored["params"]),
                                    tree_leaves(plain_params))]
            assert all(same), same
            out["elastic_restore"] = dict(
                leaves=len(same), bit_equal=True, save_seconds=save_s,
                restore_seconds=restore_s)
            del restored, plain_params, p0
            gc.collect()
            torch.cuda.empty_cache()

        # ---- gpipe at S = 1 against sequential apply --------------------
        gen = torch.Generator(device="cuda").manual_seed(1)
        d = cfg.d_model
        w = torch.randn((d, d), generator=gen, device="cuda") * d ** -0.5
        b = torch.randn((d,), generator=gen, device="cuda") * 0.1
        xs = torch.randn((4, TRAIN_BATCH, TRAIN_SEQ, d), generator=gen,
                         device="cuda")

        def stage_fn(p, x):
            return torch.tanh(x @ p["w"] + p["b"])
        piped = gpipe(stage_fn, mesh, axis="data")({"w": w, "b": b}, xs)
        ref = torch.stack([stage_fn({"w": w, "b": b}, x) for x in xs])
        gp_err = float((piped - ref).abs().max())
        assert gp_err < 1e-5, gp_err
        out["gpipe"] = {"stages": 1, "microbatches": int(xs.shape[0]),
                        "max_abs_err": gp_err}

        # ---- every kernel wrapper refuses a CUDA DTensor ---------------
        out["refused_dtensor"] = kernels_refuse_dtensor(mesh)

        # ---- the MoE dispatch under the plan, reduced -------------------
        out["moe_sharded"] = moe_sharded_vs_plain(mesh)

        # ---- the fault-injected training run, reduced ------------------
        out["fault_run"] = fault_injected_run(os.path.join(tmp, "fault_ck"))
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    emit("distributed", **out)
    return out["launches"]


def step_kernels(fn) -> dict:
    """Normalised kernel name -> launches of one call of ``fn`` (a train
    step: each call is one more step), from a complete profile where one of
    `hlo_analysis.profile_call`'s attempts gives one; else from the last
    profile's launches that kept their device event, with the ATen op of
    each launch whose event torch.profiler lost (``lost``)."""
    from repro_torch.core import hlo_analysis as H
    try:
        prof = H.profile_call(fn)
        return {"kernels": H.kernel_histogram_of(prof),
                "profiles_taken": prof.attempts, "lost": {}}
    except H.LostDeviceEvents as err:
        kernels, lost = {}, {}
        for k in err.kernels:
            name = H.kernel_name(k.name)
            kernels[name] = kernels.get(name, 0) + 1
        for op in err.lost_ops:
            lost[op] = lost.get(op, 0) + 1
        return {"kernels": kernels, "profiles_taken": H.PROFILE_ATTEMPTS,
                "lost": lost}


def kernel_delta(plain: dict, sharded: dict) -> dict:
    """The sharded step's kernels against the plain step's.  ``launches``:
    each step's launches, copies and fills as the host made them (those
    whose device event the profile lost included); ``delta``: (name, plain,
    sharded) where the kept launches differ by kernel name, most different
    first; ``lost_device_events``: the ATen ops whose launches lost it."""
    from repro_torch.core.hlo_analysis import histogram_delta
    a, b = plain["kernels"], sharded["kernels"]
    return {"plain_launches": sum(a.values()) + sum(plain["lost"].values()),
            "sharded_launches": sum(b.values()) +
            sum(sharded["lost"].values()),
            "profiles_taken": [plain["profiles_taken"],
                               sharded["profiles_taken"]],
            "lost_device_events": {"plain": plain["lost"],
                                   "sharded": sharded["lost"]},
            "delta": [list(r) for r in histogram_delta(a, b)]}


def moe_sharded_vs_plain(mesh) -> dict:
    """One train step of reduced olmoe-1b-7b on the mesh (the experts axis
    under the training plan; the dispatch runs on each rank's rows) against
    the plain step from the same parameters: the same loss within 1e-5
    relative, expert token counts and dropped tokens.  The CPU tests hold
    the same across 4 gloo ranks; here it runs through CUDA DTensors."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.distributed.sharding import (
        distribute, distribute_batch, logical_rules, params_shardings,
        use_rules)
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.state import init_train_state, make_train_step
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              attention_impl="chunked", ssm_impl="chunked")
    plan = logical_rules(mesh, mode="train")
    opt = AdamWConfig(lr=TRAIN_LR)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticCorpus(cfg.vocab_size, 32, 4,
                                         seed=0).batch_at(0).items()
             if k in ("tokens", "labels")}
    p0 = build_model(cfg).init(torch.Generator().manual_seed(0))
    runs = {}
    for name, pl in (("plain", None), ("sharded", plan)):
        with use_rules(pl):
            model = build_model(cfg, pl)
            params, feed = tree_map(lambda t: t.clone(), p0), batch
            if pl is not None:
                params = distribute(params, params_shardings(
                    mesh, plan, model.axes()))
                feed = distribute_batch(batch, plan)
            state = init_train_state(model, params, opt)
            _, m, aux = make_train_step(model, opt, constant(TRAIN_LR))(
                state, feed)
            runs[name] = (float(m["loss"]), aux["expert_tokens"].cpu(),
                          int(aux["dropped_tokens"]))
    (lp, ep, dp), (ls, es, ds) = runs["plain"], runs["sharded"]
    assert abs(ls - lp) <= 1e-5 * abs(lp), (lp, ls)
    assert torch.equal(ep, es) and dp == ds, (ep, es, dp, ds)
    return {"arch": cfg.name, "reduced": True, "experts_spec": list(
        plan.spec(("experts", "embed", "expert_mlp"))), "loss_plain": lp,
        "loss_sharded": ls, "expert_tokens": int(es.sum()),
        "dropped_tokens": ds}


def kernels_refuse_dtensor(mesh) -> dict:
    """Each kernel wrapper, given CUDA DTensors, raises by name before it
    reads a pointer; none of them launches."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.moe_grouped import grouped_mlp
    from repro_torch.kernels.ssd import ssd_intra

    def leaf(*shape, dtype=torch.bfloat16):
        return distribute_tensor(torch.randn(shape, device="cuda",
                                             dtype=dtype),
                                 mesh, [Replicate()] * mesh.ndim)

    q, k = leaf(1, 64, 4, 64), leaf(1, 64, 4, 64)
    lengths = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": lambda: flash_attention(q, k, k, group=1),
        "flash_decode": lambda: flash_decode(q[:, :1], k, k, lengths,
                                             group=1),
        "ssd_intra": lambda: ssd_intra(
            q, leaf(1, 64, 4, dtype=torch.float32),
            leaf(4, dtype=torch.float32), leaf(1, 64, 16), leaf(1, 64, 16),
            64),
        "grouped_mlp": lambda: grouped_mlp(
            leaf(1, 64), leaf(1, 64, 64), leaf(1, 64, 64), leaf(1, 64, 64),
            *_one_entry(), top_k=1),
        "mla_decode": lambda: mla_decode(leaf(1, 16, 576), leaf(1, 64, 576),
                                         lengths, scale=1.0),
    }
    before = read_counters()
    out = {}
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            assert name in str(e) and "DTensor" in str(e), (name, e)
            out[name] = str(e)[:80]
        else:
            raise AssertionError(f"{name} ran on a CUDA DTensor")
    assert read_counters() == before
    return out


def fault_injected_run(ck_dir) -> dict:
    """`FaultInjectingRun` over the port's `Trainer` on the card at the
    reduced size (tests/test_fault_tolerance.py's run): the fleet killed at
    steps 7 and 13, each restart a fresh trainer resuming from the latest
    checkpoint; its final parameters must equal an uninterrupted run's bit
    for bit."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.faults import FaultInjectingRun
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import Trainer
    cfg = dataclasses.replace(reduced(get_config(TRAIN_ARCH)),
                              attention_impl="chunked", ssm_impl="chunked")
    fr = FAULT_RUN
    t0 = time.perf_counter()

    def trainer(**kw):
        return Trainer(cfg, seq_len=fr["seq_len"], batch=fr["batch"],
                       instrument=False, **kw)

    want = trainer().run(fr["steps"])
    box = {}

    def run_steps(frm: int, to: int) -> int:
        st = trainer(ckpt_dir=ck_dir, ckpt_every=fr["ckpt_every"]).run(to)
        box["state"] = st
        return int(st.step)

    run = FaultInjectingRun(4, run_steps, ckpt_every=fr["ckpt_every"],
                            kill_at=fr["kill_at"])
    final = run.run(fr["steps"])
    assert final == fr["steps"] and run.restarts == 2, (final, run.restarts)
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(want.params),
                                              tree_leaves(box["state"].params))]
    assert all(same), same
    return {"arch": cfg.name, "reduced": True, "steps": final,
            "restarts": run.restarts, "kill_at": sorted(fr["kill_at"].values()),
            "bit_equal": True, "leaves": len(same),
            "seconds": time.perf_counter() - t0}


# weights from seed 0.  The SSM paths prefill 512 steps: two SSD chunks, so
# the inter-chunk carry is on the path.  "qwen3-1.7b/int8" is qwen3-1.7b with
# int8 weights (`quantize_params` of the path before's) and an int8 KV cache.
# whisper-tiny's prefill runs its encoder over 1500 frames (K1 not causal)
# and 64 prompt tokens; internvl2-76b's 512 positions start with its 256
# patch positions.
# The dry-run phase: one cell per family on the single mesh and one train
# cell on the multi mesh, each in a process of its own (a fake process group
# of 256 or 512 ranks takes its process), all at once, on fake CUDA tensors.
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"),
                ("qwen3-1.7b", "decode_32k", "single"),
                ("olmoe-1b-7b", "prefill_32k", "single"),
                ("mamba2-780m", "long_500k", "single"),
                ("zamba2-1.2b", "train_4k", "single"),
                ("whisper-tiny", "decode_32k", "single"),
                ("qwen3-1.7b", "train_4k", "multi"))
DRYRUN_TIMEOUT_S = 140          # the phase's budget is 150 s
# The one-card check's cells: the train configuration (TRAIN_BATCH x
# TRAIN_SEQ, remat, microbatch 1) and the serving smoke configuration (a
# decode step of batch 8 over a cache of 1024, and one prefill of 256
# tokens), on a (1, 1) mesh of this card.
SERVE_PREFILL = 256


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _active_blocks() -> dict:
    """The caching allocator's allocated blocks: address -> (block size,
    the size that was asked for)."""
    return {b["address"]: (b["size"], b["requested_size"])
            for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
            if b["state"] == "active_allocated"}


def _allocated_by(build):
    """(the tree ``build()`` returns, what the card allocated for it: the
    increase of `memory_allocated`, the bytes its new blocks asked for and
    their block sizes, its tensor leaves)."""
    gc.collect()
    torch.cuda.synchronize()
    before, m0 = _active_blocks(), torch.cuda.memory_allocated()
    tree = build()
    torch.cuda.synchronize()
    new = [v for a, v in _active_blocks().items() if a not in before]
    return tree, {"increase": torch.cuda.memory_allocated() - m0,
                  "requested": sum(r for _, r in new),
                  "blocks": sum(b for b, _ in new),
                  "leaves": len(_tensor_leaves(tree))}


def _bytes_check(name, predicted, alloc, host_bytes=0) -> dict:
    """The dry-run's bytes against what the card allocated for the same
    tree.  The bytes the new blocks asked for equal the prediction (less
    ``host_bytes``, a leaf the port keeps on the host), and the increase of
    `memory_allocated` is those blocks' sizes: the allocator's rounding,
    512 B a block, or the remainder of a large-pool block of 1 MiB or less,
    which it does not split off."""
    assert alloc["requested"] == predicted - host_bytes, (name, predicted,
                                                          alloc)
    assert alloc["increase"] == alloc["blocks"], (name, alloc)
    return {"predicted": predicted, **alloc,
            "increase_minus_predicted": alloc["increase"] - predicted}


def _bound_check(name, cell, measured_ms) -> dict:
    """The roofline's bound of ``cell`` against the card's device-busy
    time of the same work: a bound above the measurement means the dry-run
    counted work that the step does not do."""
    from repro_torch.launch.roofline import analyze_cell
    row = analyze_cell(cell)
    bound_ms = max(row["compute_s"], row["memory_s"],
                   row["collective_s"]) * 1e3
    assert bound_ms <= measured_ms, (name, bound_ms, measured_ms, row)
    return {"bound_ms": bound_ms, "dominant": row["dominant"],
            "measured_device_busy_ms": measured_ms,
            "bound_over_measured": bound_ms / measured_ms}


# The gap allowed between the allocator's requested peak over a step and
# the dry-run's predicted peak (`mem_argument + mem_temp`), less the
# arguments that the port keeps on the host (a train state's key): none.
# On the card (torch 2.11.0+cu128, NVIDIA H100 80GB HBM3, 700.00 W) the
# requested bytes rose over the train step and over a chunked decode step by
# the predicted temporaries to the byte: no kernel of either step asks the
# allocator for scratch of its own (cuBLAS's workspace is the handle's, made
# at the first call before them).
MEMORY_GAP_BYTES = 0


def _peak_check(name, cell, fn, args) -> dict:
    """The dry-run's memory analysis of ``cell`` against one call of ``fn``
    on this card: the predicted peak, ``mem_argument_size_in_bytes +
    mem_temp_size_in_bytes`` less the arguments that lie on the host,
    against the bytes of the arguments' storages on the card (``args``; the
    bytes checks hold them equal to the dry-run's) plus the rise of the
    allocator's requested bytes (`requested_bytes.all.peak`: what was asked
    for, not the blocks' sizes) over the call."""
    from repro_torch.core.hlo_analysis import tree_storages
    bufs = tree_storages(args, {}).values()
    on_card = sum(b.nbytes() for b in bufs
                  if isinstance(b, torch.UntypedStorage)
                  and b.device.type == "cuda")
    on_host = sum(b.nbytes for b in bufs if not isinstance(
        b, torch.UntypedStorage))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = fn()
    torch.cuda.synchronize()
    rise = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    del out
    predicted = cell["mem_argument_size_in_bytes"] - on_host + \
        cell["mem_temp_size_in_bytes"]
    measured = on_card + rise
    assert on_card == cell["mem_argument_size_in_bytes"] - on_host, \
        (name, on_card, on_host, cell)
    assert abs(measured - predicted) <= MEMORY_GAP_BYTES, \
        (name, predicted, measured, cell)
    return {"predicted_peak": predicted, "measured_peak": measured,
            "gap_bytes": measured - predicted, "limit": MEMORY_GAP_BYTES,
            "arguments": cell["mem_argument_size_in_bytes"],
            "arguments_on_host": on_host,
            "temp": cell["mem_temp_size_in_bytes"], "requested_rise": rise,
            "output": cell["mem_output_size_in_bytes"],
            "alias": cell["mem_alias_size_in_bytes"]}


def one_card_check(tmp) -> dict:
    """The dry-run held against this card at one rank.  Each cell is priced
    by `dryrun.run_cell` on a (data 1, model 1) mesh of the card (NCCL at
    world size 1); then the port builds the same trees on the card, and the
    bytes per device must equal the increase of `memory_allocated` (within
    the allocator's rounding of each leaf), and the roofline's bound must
    not exceed the device-busy time that torch.profiler measures for the
    same step: the train step (chunked impls, as the dry-run prices it), a
    decode step and a prefill with the kernels (K2 and K1 once a layer,
    counted).  The bytes are held exactly against what the allocator's new
    blocks asked for; the increase of `memory_allocated` is those blocks'
    sizes (`_bytes_check`).  The memory analysis: the train step and a
    decode step on the impls the dry-run prices ("chunked"), so that the
    program is the priced one op for op, each within `MEMORY_GAP_BYTES` of
    the predicted peak (`_peak_check`)."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.state import init_train_state, make_train_step

    shapes = {"train": ShapeConfig("smoke_train", "train", TRAIN_SEQ,
                                   TRAIN_BATCH),
              "decode": ShapeConfig("smoke_decode", "decode", 1024, 8),
              "prefill": ShapeConfig("smoke_prefill", "prefill",
                                     SERVE_PREFILL, 1)}
    init_process_group(os.path.join(tmp, "dryrun_store"), 0, 1,
                       timeout_s=300)
    try:
        mesh = make_host_mesh(model=1)
        cells = {k: run_cell(TRAIN_ARCH, shp, "host", mesh=mesh,
                             **({"remat": "full", "microbatch_override": 1}
                                if k == "train" else {}))
                 for k, shp in shapes.items()}
    finally:
        dist.destroy_process_group()
    out = {"cells": {k: {f: c[f] for f in (
        "tp", "dp", "trace_flops_global", "flops", "lower_s")}
        for k, c in cells.items()}}
    gen = torch.Generator(device="cuda")

    # ---- the train state, and the train step's device time -------------
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), attention_impl="chunked",
                              ssm_impl="chunked", remat="full")
    model = build_model(cfg)
    table = build_block_table(model, shapes["train"])
    opt = AdamWConfig(lr=TRAIN_LR)
    state, alloc = _allocated_by(lambda: init_train_state(
        model, gen.manual_seed(0), opt, table))
    out["train_state_bytes"] = _bytes_check(          # rng: uint32[2] on
        "train state", cells["train"]["state_bytes_per_device"], alloc,
        host_bytes=state.rng.nbytes)                  # the host

    step = make_train_step(model, opt, constant(TRAIN_LR), table=table)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    step(state, batch)                              # first-call set-up
    trace = train_step_trace(lambda: step(state, batch))
    out["train_step"] = _bound_check("train step", cells["train"],
                                     trace["device_busy_ms"])
    out["train_step_memory"] = _peak_check(
        "train step", cells["train"], lambda: step(state, batch),
        (state, batch))
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the serving parameters and caches; a decode step and a prefill -
    cfg = get_config(TRAIN_ARCH)                    # the kernels' impls
    model = build_model(cfg)
    params, alloc = _allocated_by(lambda: model.init(gen.manual_seed(0)))
    for k in ("decode", "prefill"):
        out[f"{k}_params_bytes"] = _bytes_check(
            f"{k} params", cells[k]["params_bytes_per_device"], alloc)
    caches = {}
    for k, shp in shapes.items():
        if k != "train":
            caches[k], alloc = _allocated_by(
                lambda: model.init_cache(shp.global_batch, shp.seq_len))
            out[f"{k}_cache_bytes"] = _bytes_check(
                f"{k} cache", cells[k]["cache_bytes_per_device"], alloc)
    tok = torch.zeros((8, 1), dtype=torch.int32, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, SERVE_PREFILL),
                           generator=gen, device="cuda")

    def decode():
        caches["decode"]["length"].fill_(SERVE_PREFILL + 40)
        model.decode_step(params, tok, caches["decode"])

    def prefill():
        model.prefill(params, {"tokens": prompt}, caches["prefill"])

    # the main path: counters to 0 just before, read just after
    reset_counters()
    decode()
    prefill()
    torch.cuda.synchronize()
    launches = read_counters()
    want = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers,
            "ssd_intra": 0, "grouped_mlp": 0, "mla_decode": 0}
    assert launches == want, (launches, want)
    out["launches"] = launches
    for k, fn in (("decode", decode), ("prefill", prefill)):
        out[f"{k}_step"] = _bound_check(
            k, cells[k], train_step_trace(fn)["device_busy_ms"])
    # the decode step as the dry-run prices it: the plain decode attention
    chunked = build_model(dataclasses.replace(
        cfg, attention_impl="chunked", ssm_impl="chunked"))
    cache = caches["decode"]

    def chunked_decode():
        return chunked.decode_step(params, tok, cache)
    chunked_decode()                                # first-call set-up
    out["decode_step_memory"] = _peak_check(
        "decode step", cells["decode"], chunked_decode,
        (params, {"token": tok}, cache))
    del params, caches, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_dryrun(tmp) -> dict:
    """The dry-run and the roofline on the card.  (a) The cells of
    `DRYRUN_CELLS`, each in a process of its own on fake CUDA tensors
    (`python -m repro_torch.launch.dryrun`), all at once; (b) their
    roofline rows, priced with the H100 datasheet's figures; (c) meanwhile
    the one-card check (`one_card_check`).  A cell that errs fails the
    phase."""
    from repro_torch.launch.dryrun import cell_id
    from repro_torch.launch.roofline import SPEC_NOTE, analyze_cell
    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "dryrun_cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        procs[cell_id(arch, shape, mesh)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", out_dir],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
    try:
        one = one_card_check(tmp)
        errs = {}
        for cell, proc in procs.items():
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t_phase)
            _, err = proc.communicate(timeout=max(left, 1.0))
            if proc.returncode != 0:
                errs[cell] = err[-3000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, errs
    cells, rows = [], []
    for cell in procs:
        with open(os.path.join(out_dir, cell + ".json")) as f:
            c = json.load(f)
        assert c["status"] == "ok", c
        assert c["kernel_launches"] == {k: 0 for k in KERNELS}, c
        cells.append({k: c.get(k) for k in (
            "cell", "status", "tp", "dp", "eff_devices", "microbatch",
            "microbatch_traced", "params_bytes_per_device",
            "cache_bytes_per_device", "state_bytes_per_device",
            "trace_flops_global", "flops", "collective_bytes",
            "kernel_launches", "total_s")})
        rows.append({k: v for k, v in analyze_cell(c).items()
                     if k != "lever"})
    out = {"cells": cells, "roofline": rows, "priced_with": SPEC_NOTE,
           "one_card": one, "seconds": time.perf_counter() - t_phase}
    emit("dryrun", **out)
    launches = {k: sum(c["kernel_launches"][k] for c in cells)
                for k in KERNELS}
    return {f"{TRAIN_ARCH}/dryrun": launches,
            f"{TRAIN_ARCH}/one_card": one["launches"]}


# (path, prefill length, max_seq): the serving paths in the order they run.
# gemma3-4b's prompts of 1536 tokens and a max_seq of 2048 put every prefill
# and every decode step past its local layers' window of 1024 tokens.
PATHS = (("qwen3-1.7b", 256, 1024), ("qwen3-1.7b/int8", 256, 1024),
         ("qwen3-1.7b/int4", 256, 1024), ("mamba2-780m", 512, 1024),
         ("zamba2-1.2b", 512, 1024), ("olmoe-1b-7b", 256, 1024),
         ("whisper-tiny", 64, 1024), ("internvl2-76b", 512, 1024),
         ("gemma3-4b", 1536, 2048), ("qwen2.5-14b", 256, 1024),
         ("llama4-scout-17b-a16e", 256, 1024),
         ("mistral-large-123b", 256, 1024), ("deepseek-v2-lite", 512, 1024))
VARIANTS = {"int8": dict(weight_quant="int8", cache_quant="int8"),
            "int4": dict(weight_quant="int4")}
# the variants whose weights are quantized from their base path's
# (`quantize_params`); int4 has no quantizer, in the reference either
QUANTIZED_FROM_BASE = ("int8",)
# Depth cuts (layers served), for paths whose full depth does not fit on the
# card in bf16: internvl2-76b's 80 layers are 141 GB of weights (8 layers at
# its published widths: 9.0 B parameters), llama4-scout-17b-a16e's 48 layers
# 216 GB (107.8 B parameters; 4 layers: 10.9 B) and mistral-large-123b's 88
# layers 245 GB (4 layers: 6.3 B).
SERVE_DEPTH = {"internvl2-76b": 8, "llama4-scout-17b-a16e": 4,
               "mistral-large-123b": 4}
# Where a path's random weights are drawn (the generator's device; seed 0
# either way).  olmoe-1b-7b's 6.92 B values take 50.5 to 67.1 s on the CPU
# generator (three runs on one H100's host), more than the rest of its
# path, so they are drawn on the card, as are the other paths' of more than
# 3 B values.
SERVE_INIT_DEVICE = {name: "cuda" for name in (
    "olmoe-1b-7b", "internvl2-76b", "gemma3-4b", "qwen2.5-14b",
    "llama4-scout-17b-a16e", "mistral-large-123b", "deepseek-v2-lite")}


def path_config(path: str):
    """The config of a serving path: an arch, a variant after a slash, the
    depth cut of `SERVE_DEPTH`."""
    from repro_torch.configs import get_config
    arch, _, variant = path.partition("/")
    cfg = get_config(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    return cfg
TRAIN_ARCH = "qwen3-1.7b"      # the train path, after the serving paths


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="device,build,kernels,serve,profile,accuracy,"
                            "train,pipeline,distributed,dryrun")
    ap.add_argument("--paths", default=",".join(p[0] for p in PATHS),
                    help="serving paths to drive, of: " + ", ".join(
                        p[0] + (f" ({SERVE_DEPTH[p[0]]} layers)"
                                if p[0] in SERVE_DEPTH else "")
                        for p in PATHS)
                    + " (a subset while developing)")
    ap.add_argument("--ptxas", metavar="FILE", default="",
                    help="build with -Xptxas -v and write the compiler's "
                         "output (registers, spills) to FILE")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script only runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config

    chosen = args.paths.split(",")
    paths = [(a, path_config(a), pl, ms) for a, pl, ms in PATHS
             if a in chosen]
    batch, n_requests = 8, 16

    dev = phase_device()
    if "build" in phases:
        phase_build(args.ptxas)
    checks = phase_kernels(paths, batch) \
        if "kernels" in phases else None
    if "plans" in phases:
        phase_plans(paths, batch)
    per_path = {}
    if "serve" not in phases:
        if "accuracy" in phases:
            phase_accuracy()
        if "train" in phases:
            phase_train(get_config(TRAIN_ARCH))
            phase_train_moe()
        if "pipeline" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                phase_pipeline(tmp)
        if "distributed" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                phase_distributed(tmp)
        if "dryrun" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                phase_dryrun(tmp)
        return 0
    carry = {}      # a quantized path's inputs, from its base path's run
    for path, cfg, prefill_len, max_seq in paths:
        eng, launches, params, logits = phase_serve(
            path, cfg, batch, max_seq, prefill_len, n_requests,
            given=carry.pop(path, None))
        per_path[path] = launches
        if "trace" in phases:
            phase_trace(path, eng, params, prefill_len)
        if "profile" in phases:
            phase_profile(path, eng)
        for variant in QUANTIZED_FROM_BASE:
            if f"{path}/{variant}" in chosen:
                from repro_torch.models.layers import quantize_params
                carry[f"{path}/{variant}"] = {
                    "params": quantize_params(params, eng.model.axes()),
                    "logits": logits}
        del eng, params, logits
        gc.collect()
        torch.cuda.empty_cache()
    if "accuracy" in phases:
        per_path.update(phase_accuracy())
    if "train" in phases:
        per_path[f"{TRAIN_ARCH}/train"] = phase_train(get_config(TRAIN_ARCH))
        per_path[f"{MOE_TRAIN['arch']}/train"] = phase_train_moe()
    if "pipeline" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            launches = phase_pipeline(tmp)
        for arch, n in launches.items():
            per_path[f"{arch}/pipeline"] = n
    if "distributed" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            per_path[f"{TRAIN_ARCH}/distributed"] = phase_distributed(tmp)
    if "dryrun" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            per_path.update(phase_dryrun(tmp))
    if checks is None or len(paths) < len(PATHS) or any(
            p not in phases for p in ("accuracy", "train", "pipeline",
                                      "distributed", "dryrun")):
        return 0

    kernels = []
    timed = ("arch", "shape", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "bound_share", "max_abs_err")
    for name in KERNELS:
        fw = checks[name]["full_width"][0]
        launches = {arch: n[name] for arch, n in per_path.items()}
        long = checks[name].get("long")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(launches.values()),
            "launches_per_path": launches, "shape_of": fw["arch"],
            "max_abs_err": fw["max_abs_err"], "ms": fw["ms"],
            "plain_ms": fw["plain_ms"], "bound_ms": fw["bound_ms"],
            "bound_by": fw["bound_by"], "library_ms": fw["library_ms"],
            "sources": SOURCES_ALL[name],
            "full_width": [{key: r[key] for key in timed}
                           for r in checks[name]["full_width"]],
            "long": None if long is None else {key: long[key] for key in timed}})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
