"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Every configuration, traffic mix, set of limits and per-layer metric is a
file of its own, found by its name under the benchmark's folder:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``checks/<workload>.json`` and ``metrics/<metric>.py``.  A configuration
names its family, whose module under ``reference/`` holds the plain
reference, the weights and the operation counts; a traffic mix names its
kind, whose runner is ``harness/<kind>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    data_dir: Path

    @property
    def name(self) -> str:
        return self.workload["name"]

    def family(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.reference.{self.config['family']}")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in
                m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if m["moves"] in e2e and self.name in
                m.get("workloads", [self.name])]

    def metric_reader(self, name: str) -> ModuleType:
        path = self.data_dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, bench_path: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``bench_path`` (the root's BENCHMARK.json
    by default), its files read from the folder beside it that holds
    ``configs/``: the first of ``paths``."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    bench = _read_json(bench_path)
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    w = cells[workload]
    data_dir = bench_path.parent / bench["paths"][0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(bench=bench, workload=w,
                config=_read_json(bench_path.parent / cfg["file"]),
                traffic=_read_json(data_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(data_dir / "checks" / f"{workload}.json"),
                data_dir=data_dir)
