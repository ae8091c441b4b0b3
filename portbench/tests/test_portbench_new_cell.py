"""A configuration and a cell added to the benchmark as new files only, as a
later change adds one: in a copy of the checkout, a configuration file, a
traffic mix, a limits file, a small twin and its small configuration are
added, and BENCHMARK.json gains their entries.  No file the benchmark's
folder already holds changes, and the grown benchmark passes the contract's
rules and runs its new cell and the new twin end to end on the CPU."""
import hashlib
import json
import shutil

import pytest

from conftest import (BENCH, ROOT, SMALL_CONFIGS, SMALL_TRAFFIC, TWINS,
                      load_small_configs, load_twins, make_small_bench,
                      run_cell, twin_errors)
from test_portbench_contract import CHECKS, JAX_NAMES, imported_top_names

CONFIG, MIX = "olmoe-tiny", "chat-tiny"
CELL = f"{CONFIG}.{MIX}"
TWIN = f"{CONFIG}-twin.{MIX}"


def digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(root):
    """The new files and BENCHMARK.json's new entries: a renamed copy of
    the small configuration under a mix of its own, its twin, and the
    twin's configuration cut from it."""
    data = root / "portbench"
    chat = next(t for t in TWINS if t["cell"] == "olmoe-small.chat")
    config = dict(SMALL_CONFIGS["olmoe-small"], name=CONFIG)
    mix = dict(SMALL_TRAFFIC["olmoe-small.chat"], schedule_seed=7)
    (data / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    (data / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    (data / "checks" / f"{CELL}.json").write_text(json.dumps(chat["limits"]))
    twins = data / "tests" / "twins"
    (twins / "configs" / f"{CONFIG}-twin.json").write_text(json.dumps(
        {"of": CONFIG, "overrides": {"num_hidden_layers": 1}}))
    (twins / f"{TWIN}.json").write_text(json.dumps(
        dict(chat, twin_of=CELL, config=f"{CONFIG}-twin",
             mix=dict(mix, batch=2))))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": CONFIG, "source": "https://example.org/tiny",
                         "file": f"portbench/configs/{CONFIG}.json",
                         "reduced": [], "why": "a tiny copy"})
    b["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX,
                           "chips": 1, "why": "a tiny chat"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return b


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A checkout whose benchmark gained the cell: its own copy of the
    benchmark's folder, the port beside it."""
    root = tmp_path_factory.mktemp("grown")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    before = digests(root / "portbench")
    b = add_cell(root)
    return root, b, before


def test_no_file_of_the_benchmark_changes(grown):
    root, _, before = grown
    after = digests(root / "portbench")
    assert {p: after[p] for p in before} == before
    assert sorted(map(str, set(after) - set(before))) == sorted([
        f"checks/{CELL}.json", f"configs/{CONFIG}.json",
        f"tests/twins/{TWIN}.json", f"tests/twins/configs/{CONFIG}-twin.json",
        f"traffic/{MIX}.json"])


@pytest.mark.parametrize("check", CHECKS, ids=lambda c: c.__name__)
def test_the_grown_benchmark_keeps_the_rules(grown, check):
    root, b, _ = grown
    check(b, root)


def test_the_grown_benchmark_has_a_twin_for_each_cell(grown):
    root, b, _ = grown
    twins_dir = root / "portbench" / "tests" / "twins"
    twins = load_twins(twins_dir)
    assert twin_errors(twins, b, load_small_configs(twins_dir)) == []
    assert {w["name"] for w in b["workloads"]} <= {t["twin_of"]
                                                   for t in twins}
    for p in (root / "portbench").rglob("*.py"):
        assert not set(imported_top_names(p)) & JAX_NAMES


def test_the_new_cell_runs_from_the_grown_checkout(grown):
    """The grown checkout's own harness runs its new cell with no flag:
    the cell is found by its name alone."""
    root, _, _ = grown
    rc, out, err = run_cell(None, CELL, device="cpu", cwd=root)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "serve_tokens_per_s"}


def test_the_new_twin_runs_in_the_small_benchmark(grown, tmp_path):
    root, _, _ = grown
    bench = make_small_bench(tmp_path, root)
    cells = [w["name"] for w in json.loads(bench.read_text())["workloads"]]
    assert TWIN in cells and len(cells) == len(TWINS) + 1
    rc, out, err = run_cell(bench, TWIN, trace=1)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    assert "model_step.moe_slot_fill.serve" in out["metrics"]
