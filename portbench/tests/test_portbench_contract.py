"""BENCHMARK.json against the benchmark's rules, every file it names
found by name, and the harness's refusals: no card, a bare directory, and
JAX or the JAX package loaded.  Each rule is a ``check_*`` function of a
benchmark's data and its checkout, so that a benchmark grown by new files
can be held to the same rules."""
import ast
import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT, run_cell

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj).*size|_dim$|"
                   r"_rank$|head|expand|experts_per_tok", re.I)
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def check_top_level_keys_and_command(b, root):
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def check_names_units_and_lines(b, root):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def check_configs_and_cells(b, root):
    bench = root / "portbench"
    configs = {c["name"]: c for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        data = json.loads((root / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(data.get("changed_from_source", {}))
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "checks" / f"{w['name']}.json").is_file()


def check_metrics_and_their_cells(b, root):
    bench = root / "portbench"
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m["workloads"]) <= cells if "workloads" in m else True

    def reports(cell, m):
        return cell in m.get("workloads", cells)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert reports(cell, e2e[m["moves"]])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        own = [m for m in b["end_to_end"] if reports(cell, m)]
        assert len(own) >= 2
        assert any(reports(cell, m) for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in k for k in layers)


def check_limits_and_mfu(b, root):
    for w in b["workloads"]:
        limits = json.loads((root / "portbench" / "checks" /
                             f"{w['name']}.json").read_text())
        assert all(isinstance(v, (int, float)) and v >= 0
                   for v in limits.values())
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       for x in b["per_layer"])


CHECKS = [check_top_level_keys_and_command, check_names_units_and_lines,
          check_configs_and_cells, check_metrics_and_their_cells,
          check_limits_and_mfu]


def test_top_level_keys_and_command():
    check_top_level_keys_and_command(B, ROOT)


def test_names_units_and_lines():
    check_names_units_and_lines(B, ROOT)


def test_configs_and_cells():
    check_configs_and_cells(B, ROOT)


def test_metrics_and_their_cells():
    check_metrics_and_their_cells(B, ROOT)


def test_every_check_has_a_limit_and_every_roofline_a_mfu_beside_it():
    check_limits_and_mfu(B, ROOT)


def imported_top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH) for p in
                                        BENCH.rglob("*.py")), ids=str)
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not set(imported_top_names(BENCH / path)) & JAX_NAMES


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert not {n for n in imported_top_names(p)
                    if n.startswith("repro")}


def test_the_guard_names_whole_top_level_modules():
    import sys
    import types
    from portbench.harness.main import loaded_jax
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] in JAX_NAMES}
    try:
        sys.modules["repro_torch_like"] = types.ModuleType("repro_torch_like")
        assert loaded_jax() == []
        sys.modules["repro.models"] = types.ModuleType("repro.models")
        assert loaded_jax() == ["repro"]
    finally:
        sys.modules.pop("repro_torch_like", None)
        sys.modules.pop("repro.models", None)
        sys.modules.update(saved)


def test_a_run_that_loaded_the_jax_package_prints_no_result(small_bench):
    rc, out, err = run_cell(small_bench, "olmoe-small.chat", patch=(
        "import types\nsys.modules['repro'] = types.ModuleType('repro')"))
    assert rc != 0 and out is None
    assert "repro" in err.strip().splitlines()[-1]


def test_no_card_no_result(small_bench):
    rc, out, err = run_cell(small_bench, "olmoe-small.chat", device="cuda")
    assert rc != 0 and out is None


def test_a_bare_checkout_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, out, err = run_cell(None, B["workloads"][0]["name"], cwd=tmp_path,
                            device="cpu")
    assert rc != 0 and out is None
