"""A small benchmark beside the real one, made of new files only: a copy of
the benchmark's folder with small configurations, traffic mixes and limits
added, and a BENCHMARK.json of its own that names them.  Each small cell is
the twin of a real cell, read from its own file under ``twins/``, so that a
cell is added to both benchmarks by new files alone.  The harness runs its
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
from typing import Dict, List

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TWINS_DIR = BENCH / "tests" / "twins"


def load_twins(twins_dir: Path = TWINS_DIR) -> List[dict]:
    """The small twins, one file a small cell (``<small cell>.json``): the
    real cell it stands for (``twin_of``), its small configuration
    (``config``, the name of a file under ``configs/`` there), its mix
    (``mix``, named after the small cell) and its ``limits``."""
    return [dict(json.loads(p.read_text()), cell=p.stem)
            for p in sorted(twins_dir.glob("*.json"))]


def load_small_configs(twins_dir: Path = TWINS_DIR) -> Dict[str, dict]:
    """The small configurations, one file each (``configs/<name>.json``):
    the real configuration it is cut from (``of``) and the keys it changes
    (``overrides``)."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((twins_dir / "configs").glob("*.json"))}


def twin_errors(twins: List[dict], bench: dict,
                small_configs: Dict[str, dict]) -> List[str]:
    """What is wrong with the twins against ``bench`` (a BENCHMARK.json's
    data): a twin of no real cell, or of a small configuration with no
    file."""
    cells = {w["name"] for w in bench["workloads"]}
    return ([f"{t['cell']}: twin_of {t['twin_of']!r} is no cell"
             for t in twins if t["twin_of"] not in cells]
            + [f"{t['cell']}: config {t['config']!r} has no file"
               for t in twins if t["config"] not in small_configs])


def small_benchmark(twins: List[dict], small_configs: Dict[str, dict],
                    bench: dict, root: Path):
    """(configurations, mixes, cells) of the twins: each configuration the
    real configuration's file under ``root`` with the small one's
    overrides; each mix named after its small cell; each cell (small cell,
    configuration, mix, the real cell whose metrics it reports).  A twin
    that ``twin_errors`` finds at fault is left out."""
    cells = {w["name"] for w in bench["workloads"]}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    configs, mixes, small = {}, {}, []
    for t in twins:
        if t["twin_of"] not in cells or t["config"] not in small_configs:
            continue
        c = small_configs[t["config"]]
        real = json.loads((root / files[c["of"]]).read_text())
        configs[t["config"]] = {**real, "name": t["config"], **c["overrides"]}
        mixes[t["cell"]] = t["mix"]
        small.append((t["cell"], t["config"], t["cell"], t["twin_of"]))
    return configs, mixes, small


TWINS, TWIN_CONFIGS = load_twins(), load_small_configs()
SMALL_CONFIGS, SMALL_TRAFFIC, SMALL_CELLS = small_benchmark(
    TWINS, TWIN_CONFIGS, json.loads((ROOT / "BENCHMARK.json").read_text()),
    ROOT)


def make_small_bench(where: Path, root: Path = ROOT) -> Path:
    """The small benchmark under ``where``, made from the benchmark of the
    checkout ``root`` and its twins; returns its BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    twins_dir = root / "portbench" / "tests" / "twins"
    twins = load_twins(twins_dir)
    configs, mixes, cells = small_benchmark(
        twins, load_small_configs(twins_dir), bench, root)
    limits = {t["cell"]: t["limits"] for t in twins}
    data = where / "portbench"
    shutil.copytree(root / "portbench", data, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, c in configs.items():
        (data / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, t in mixes.items():
        (data / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bench["configs"] = [{"name": n, "source": "https://example.org/" + n,
                         "file": f"portbench/configs/{n}.json", "reduced": [],
                         "why": "small"} for n in configs]
    bench["workloads"] = []
    for cell, config, mix, _ in cells:
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1, "why": "small"})
        (data / "checks" / f"{cell}.json").write_text(
            json.dumps(limits[cell]))
    # each small cell reports the metrics of its real twin
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c[0] for c in cells if c[3] in m["workloads"]]
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
