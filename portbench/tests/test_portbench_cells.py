"""Each cell's harness run end to end on the CPU at a small size, checked
against the plain reference, and the result line's schema.  The small cells
are new files only (see conftest.py): the harness runs them as they are."""
import json

import pytest

from conftest import SMALL_CELLS, run_cell

SERVE = [c[0] for c in SMALL_CELLS]


def check_schema(out, bench, cell, trace):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    b = json.loads(bench.read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in b["per_layer"]}
    else:
        names = {m["name"] for m in b["end_to_end"]}
        assert "setup_s" in out["metrics"]
    units = {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
    for name, m in out["metrics"].items():
        assert name in names and m["unit"] == units[name]
        assert m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", SERVE)
def test_serve_cell_runs_and_agrees_with_the_reference(small_bench, cell,
                                                        trace):
    rc, out, err = run_cell(small_bench, cell, trace=trace)
    assert rc == 0, err[-3000:]
    check_schema(out, small_bench, cell, trace)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["served_gap"]["value"] < 1e-4
    lines = err.strip().splitlines()
    assert lines[-1].startswith("check ")        # the limits come last
    if not trace:
        assert set(out["metrics"]) == {"setup_s", "serve_tokens_per_s"}


class _Done:
    def __init__(self, req_id, n):
        self.req_id, self.output = req_id, [0] * n


def test_the_sample_holds_the_longest_and_others_drawn_from_the_seed():
    from portbench.harness.check import serve_sample
    done = [_Done(i, n) for i, n in enumerate([5, 40, 7, 9, 12, 3, 8, 6])]
    a = serve_sample(done, 4, 2 ** 33 + 1)
    assert len(a) == 4 and a[0].req_id == 1
    assert len({r.req_id for r in a}) == 4
    assert [r.req_id for r in a] == [
        r.req_id for r in serve_sample(done[::-1], 4, 2 ** 33 + 1)]
    others = {tuple(r.req_id for r in serve_sample(done, 4, s))
              for s in range(8)}
    assert len(others) > 1
    assert len(serve_sample(done, 20, 3)) == len(done)
    assert serve_sample([], 4, 3) == []


def test_a_metric_added_as_a_file_is_read(small_bench, tmp_path):
    """A per-layer metric added as a reader file and an entry is read."""
    import shutil
    where = tmp_path / "b"
    shutil.copytree(small_bench.parent, where)
    (where / "portbench" / "metrics" / "engine.iters.serve.py").write_text(
        "def read(run):\n    return run['iters']\n")
    b = json.loads((where / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "engine.iters.serve", "unit": "iters",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "serve_tokens_per_s",
                           "workloads": ["olmoe-small.chat"]})
    (where / "BENCHMARK.json").write_text(json.dumps(b))
    rc, out, err = run_cell(where / "BENCHMARK.json", "olmoe-small.chat",
                            trace=1)
    assert rc == 0, err[-3000:]
    assert out["metrics"]["engine.iters.serve"]["value"] > 0


def noted(err, what):
    """The value that the run's stderr note ``what`` gave."""
    line = next(x for x in err.splitlines() if x.startswith(what + ": "))
    return json.loads(line[len(what) + 2:])


@pytest.mark.parametrize("cell", SERVE)
def test_the_slot_fill_counts_the_window_alone(small_bench, cell):
    """The window's differences of ``moe.entries`` and ``moe.slots`` are the
    shape arithmetic of the iterations in it: on the CPU's buffer path, a
    prefill routes its prompt over every expert's capacity, a decode step
    each row over every expert's 8 rows."""
    from portbench.reference.olmoe import capacity, dims
    from conftest import SMALL_CELLS, SMALL_CONFIGS, SMALL_TRAFFIC
    _, config, mix, _ = next(c for c in SMALL_CELLS if c[0] == cell)
    c, t = SMALL_CONFIGS[config], SMALL_TRAFFIC[mix]
    m = dims(c)
    rc, out, err = run_cell(small_bench, cell)
    assert rc == 0, err[-3000:]
    run, inputs = noted(err, "run"), noted(err, "per-layer inputs (host clock)")
    p, d = run["prefills_in_window"], run["decodes_in_window"]
    assert p + d == inputs["iters"] > 0
    assert inputs["moe_entries"] == m["L"] * m["k"] * (
        p * t["prompt_len"] + d * t["batch"])
    assert inputs["moe_slots"] == m["L"] * m["E"] * (
        p * capacity(t["prompt_len"], c) + d * t["batch"] * capacity(1, c))


def test_a_family_without_a_kernel_has_no_roofline():
    """A family module without ``k1_work`` or ``k2_work`` gives no bounds,
    and the roofline reader then returns nothing."""
    import re
    import types
    from portbench.harness.readers import k1_bounds, k2_bounds, roofline
    from portbench.reference import olmoe
    fam = types.SimpleNamespace(dims=olmoe.dims)
    run = {"family": fam, "config": {}, "prompt_len": 8,
           "slice_steps": [("prefill", None), ("decode", [8, 9])],
           "trace": {"kernels": [("flash_attention_kernel", 1e-3)]}}
    assert k1_bounds(run) == [] and k2_bounds(run) == []
    assert roofline(run, re.compile("flash_attention"), k1_bounds(run)) is None
