"""Faults planted in the program under a whole harness run, and the float8
control in the program's place: each has to turn ``correct`` false.  On the
CPU the look for a card is skipped and the cell is small; the tests marked
``cuda`` run the benchmark's own cells on the card at their own size."""
import json
import shutil

import pytest

from conftest import (BENCH, ROOT, SMALL_CELLS, TWIN_CONFIGS, TWINS,
                      load_small_configs, load_twins, run_cell, twin_errors)

TOKEN_ALTERED = """
import repro_torch.serve.engine as engine
_greedy = engine.greedy
engine.greedy = lambda logits: (_greedy(logits) + 1) % logits.shape[-1]
"""
# a decode step that leaves its state as it was: the attention cache is not
# written
STATE_UNCHANGED = """
import repro_torch.models.decode as decode
decode._write_kv = lambda k_l, v_l, *rest, **kw: (k_l, v_l)
"""
FAULTS = {"token_altered": TOKEN_ALTERED, "state_unchanged": STATE_UNCHANGED}
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
# the open loop on a clock that advances 5 ms an engine iteration and jumps
# over idle waits: the window holds the same iterations, and the check
# compares the same tokens, however fast the host
STEPPED_CLOCK = """
import repro_torch.serve.engine as engine
from portbench.harness import serve
CLOCK = [0.0]
_step = engine.ServeEngine.step
def step(self, params):
    busy = _step(self, params)
    CLOCK[0] += 0.005 * busy
    return busy
engine.ServeEngine.step = step
class SteppedLoop(serve.OpenLoop):
    def now(self):
        return CLOCK[0]
    def wait_until(self, t):
        CLOCK[0] = max(CLOCK[0], t)
serve.OpenLoop = SteppedLoop
"""


def failed_checks(out):
    return [k for k, c in out["checks"].items()
            if c["value"] is None or not c["value"] <= c["limit"]]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [c[0] for c in SMALL_CELLS])
def test_serve_fault_fails_the_check(small_bench, cell, fault):
    rc, out, err = run_cell(small_bench, cell, patch=FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert out["correct"] is False
    assert out["checks"]["served_gap"]["value"] > \
        out["checks"]["served_gap"]["limit"]


def held_to_the_real_limits(small_bench, tmp_path, small):
    """The small benchmark, with the small cell ``small`` held to the
    limits file of the real cell it stands for."""
    where = tmp_path / "b"
    shutil.copytree(small_bench.parent, where)
    real = next(c[3] for c in SMALL_CELLS if c[0] == small)
    shutil.copy(BENCH / "checks" / f"{real}.json",
                where / "portbench" / "checks" / f"{small}.json")
    return where / "BENCHMARK.json"


def test_every_cell_has_a_small_twin():
    assert set(CELLS) <= {c[3] for c in SMALL_CELLS}


def test_every_twin_stands_for_a_real_cell():
    assert twin_errors(TWINS, BENCHMARK, TWIN_CONFIGS) == []
    assert len(SMALL_CELLS) == len(TWINS)


@pytest.mark.parametrize("fault,error", [
    ({"twin_of": "olmoe-1b-7b.no-such-mix"},
     "twin_of 'olmoe-1b-7b.no-such-mix' is no cell"),
    ({"config": "olmoe-none"}, "config 'olmoe-none' has no file")],
    ids=["no-cell", "no-config"])
def test_a_bad_twin_fails_the_twin_check(tmp_path, fault, error):
    shutil.copytree(BENCH / "tests" / "twins", tmp_path / "twins")
    stray = json.loads((tmp_path / "twins" / "olmoe-small.chat.json")
                       .read_text())
    (tmp_path / "twins" / "olmoe-small.stray.json").write_text(json.dumps(
        dict(stray, **fault)))
    errors = twin_errors(load_twins(tmp_path / "twins"), BENCHMARK,
                         load_small_configs(tmp_path / "twins"))
    assert errors == [f"olmoe-small.stray: {error}"]


@pytest.mark.parametrize("cell", [c[0] for c in SMALL_CELLS])
def test_the_precision_control_fails_the_check(small_bench, tmp_path, cell):
    """Under the real cell's own limits the program's run is correct, and
    the reference in float8 put in its place is not (on the stepped clock,
    so that both runs compare the same tokens on any host)."""
    bench = held_to_the_real_limits(small_bench, tmp_path, cell)
    rc, out, err = run_cell(bench, cell, patch=STEPPED_CLOCK)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    rc, out, err = run_cell(bench, cell, "--control", "1",
                            patch=STEPPED_CLOCK)
    assert rc == 0, err[-3000:]
    assert out["correct"] is False
    assert set(failed_checks(out)) & {"served_gap", "served_gap_mean"}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["control"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.cuda
def test_on_the_card_at_the_cells_size(cell, fault, capsys):
    """The cell as the benchmark runs it, with a fault planted or the
    control judged: ``correct`` false.  The numbers are printed."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    extra = ("--control", "1") if fault == "control" else ()
    rc, out, err = run_cell(None, cell, *extra, device="cuda", seconds=20,
                            patch=FAULTS.get(fault, ""), seed=2 ** 31 + 77)
    assert rc == 0, err[-3000:]
    with capsys.disabled():
        print(f"{cell} {fault}: {json.dumps(out['checks'])}")
    assert out["correct"] is False
    assert set(failed_checks(out)) & {"served_gap", "served_gap_mean"}
