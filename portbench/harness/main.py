"""One run of one cell: ``--workload NAME --seed N --seconds S --trace 0|1``.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by its own reader
(``metrics/<name>.py``) from the run's record and the traced slice.  The
last line of standard output is the result; the lines before it on standard
error say what the run did, and end with each compared number beside its
limit.  With ``--control 1`` the float8 control takes the program's place
in the check: its numbers are the ones judged, and ``correct`` has to come
out false.  A run on a machine without the card (or with fewer cards than the
cell asks for), or in which the JAX package or JAX was loaded, prints no
result and exits with another code than 0.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import sys
from typing import List, Optional

import torch

from portbench.harness import spec

JAX_MODULES = {"jax", "jaxlib", "flax", "repro"}


def parse(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and calibration, never for a check:
    p.add_argument("--bench", default=None,
                   help="another BENCHMARK.json, its files beside it")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: a small cell on the kernels' plain versions")
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: judge the float8 control in the program's place")
    return p.parse_args(argv)


def loaded_jax() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's (whole names: the port's ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & JAX_MODULES)


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


def note(what: str, value) -> None:
    print(f"{what}: {json.dumps(value, default=str)}", file=sys.stderr)


def per_layer(cell, run: dict) -> dict:
    out = {}
    for m in cell.per_layer():
        value = cell.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(cell, e2e: dict) -> dict:
    out = {}
    for m in cell.end_to_end():
        value = e2e.get(m["name"])
        if value is not None and math.isfinite(value) and value > 0:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv: Optional[List[str]], t_start: float) -> int:
    args = parse(argv)
    cell = spec.load(args.workload, args.bench)
    chips = cell.workload["chips"]
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell asks for {chips} CUDA device(s); "
                  f"this machine has {n}", file=sys.stderr)
            return 3
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
        note("card", card())
    else:
        device = torch.device("cpu")
    # the mix's kind names its runner, ``harness/<kind>.py``
    runner = importlib.import_module(
        f"portbench.harness.{cell.traffic['kind']}")
    res = runner.run(cell, args, device, t_start)

    if device.type == "cuda":
        from repro_torch.kernels import build
        note("kernel build", dict(build.info))
    note("run", res["info"])
    summary = res["run"].get("trace")
    metrics = (per_layer(cell, res["run"]) if args.trace
               else end_to_end(cell, res["e2e"]))
    if not args.trace:
        note("per-layer inputs (host clock)",
             {k: v for k, v in res["run"].items()
              if isinstance(v, (int, float))})
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips if device.type == "cuda" else 1,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    result = {"correct": None, "attempted": res["attempted"],
              "failed": res["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        note("traced slice: launches on the host against device events",
             {k: summary[k] for k in ("host_launches", "device_events",
                                      "lost_device_events")})
    numbers = dict(res["checks"])
    if args.control:
        note("the program's numbers (the control is judged)", numbers)
        numbers.update(res["control"])

    checks, correct = {}, res["failed"] == 0
    for name, value in numbers.items():
        if name not in cell.limits:      # read, not compared in this cell
            note(f"reading {name}", value)
    for name, limit in cell.limits.items():
        value = numbers.get(name)        # missing: nothing was compared
        if value is not None and not math.isfinite(value):
            value = None
        correct = correct and value is not None and value <= limit
        checks[name] = {"value": value, "limit": limit}
    result["correct"] = correct
    result["checks"] = checks

    found = loaded_jax()
    if found:
        print(f"portbench: the process loaded {found}: the port must run "
              "without JAX and without the JAX package", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
