"""A small benchmark beside the real one, made of new files only: a copy of
the benchmark's folder with small configurations, traffic mixes and limits
added, and a BENCHMARK.json of its own that names them.  The harness runs its
cells on the CPU (``--device cpu``), where the port takes its kernels' plain
versions, in float32, so that the program and the reference agree to
rounding."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_CONFIGS = {
    "olmoe-small": {
        **json.loads((BENCH / "configs" / "olmoe-1b-7b.json").read_text()),
        "name": "olmoe-small", "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
        "intermediate_size": 32, "num_experts": 8, "num_experts_per_tok": 2,
        "vocab_size": 256, "dtype": "float32"},
}
SMALL_TRAFFIC = {
    "chat-small": {"kind": "serve", "why": "small", "program":
                   {"attention_impl": "cuda"}, "batch": 4, "max_seq": 48,
                   "prompt_len": 16,
                   "output": {"dist": "lognormal", "median": 4, "sigma": 0.8,
                              "lo": 2, "hi": 12},
                   "rate_per_s": 40.0, "schedule_seed": 1, "pool": 64,
                   "preroll_s": 0.3, "trace_iters": 6, "check_requests": 3},
    "longprompt-small": {"kind": "serve", "why": "small", "program":
                         {"attention_impl": "cuda"}, "batch": 3,
                         "max_seq": 48, "prompt_len": 32,
                         "output": {"dist": "uniform", "lo": 2, "hi": 6},
                         "rate_per_s": 40.0, "schedule_seed": 2, "pool": 64,
                         "preroll_s": 0.3, "trace_iters": 6,
                         "check_requests": 3},
}
SERVE_LIMITS = {"served_gap": 1e-3, "profile_steps_missing": 0}
# (small cell, configuration, mix, the real cell whose metrics it reports)
SMALL_CELLS = [("olmoe-small.chat", "olmoe-small", "chat-small",
                "olmoe-1b-7b.chat"),
               ("olmoe-small.longprompt", "olmoe-small", "longprompt-small",
                "olmoe-1b-7b.longprompt")]


def make_small_bench(where: Path) -> Path:
    """The small benchmark under ``where``; returns its BENCHMARK.json."""
    data = where / "portbench"
    shutil.copytree(BENCH, data, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, c in SMALL_CONFIGS.items():
        (data / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, t in SMALL_TRAFFIC.items():
        (data / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "https://example.org/" + n,
                         "file": f"portbench/configs/{n}.json", "reduced": [],
                         "why": "small"} for n in SMALL_CONFIGS]
    bench["workloads"] = []
    for cell, config, mix, _ in SMALL_CELLS:
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1, "why": "small"})
        (data / "checks" / f"{cell}.json").write_text(
            json.dumps(SERVE_LIMITS))
    # each small cell reports the metrics of its real twin
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c[0] for c in SMALL_CELLS
                              if c[3] in m["workloads"]]
    path = where / "BENCHMARK.json"
    path.write_text(json.dumps(bench, indent=1))
    return path


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory) -> Path:
    return make_small_bench(tmp_path_factory.mktemp("small_bench"))


# runs run.py's set-up, then ``PATCH`` (code that breaks the program where
# a fault is planted), then the harness
WRAPPER = """
import sys, time
T = time.perf_counter()
sys.path.insert(0, {bench!r})
import run
run._environment()
{patch}
from portbench.harness.main import main
sys.exit(main(sys.argv[1:], T))
"""


def run_cell(bench: Path, cell: str, *extra: str, seed: int = 2 ** 33 + 5,
             seconds: float = 0.5, trace: int = 0, patch: str = "",
             device: str = "cpu", cwd: Path = ROOT):
    """The harness in a process of its own, on the CPU unless ``device``
    says otherwise, with ``patch`` run first; (exit code, the last line of
    stdout parsed, or None where the run printed no result, stderr)."""
    args = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", device,
            *(["--bench", str(bench)] if bench else []), *extra]
    if patch:
        code = WRAPPER.format(bench=str(BENCH), patch=patch)
        cmd = [sys.executable, "-c", code, *args]
    else:
        cmd = [sys.executable, str(cwd / "portbench" / "run.py"), *args]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, env=env,
                       timeout=600)
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, out, p.stderr
