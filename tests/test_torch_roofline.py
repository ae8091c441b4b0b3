"""The port's roofline against the JAX package's, and the per-rank program's
collective statistics.

- `model_flops`, `analytic_hbm_bytes`, `analytic_collective_bytes` (and
  `_tp_ar_per_layer` under them) are the reference's functions copied
  byte for byte: their sources are equal, and on the same hand-made cell
  dicts (train, prefill, decode; FSDP; the multi-pod mesh; parallel blocks;
  every family) they return the reference's floats exactly.
- `analyze_cell`'s three times are the reference's rescaled by the ratio of
  the constants (H100 datasheet over v5e): equal within 1e-12 relative, the
  rounding of one division taken two ways.
- No name or figure of the v5e constants appears in the port.
- `collective_stats` on a hand-built list of recorded calls gives the
  reference's schema: the five kinds, each {"count", "bytes"}, operand
  bytes; `op_histogram` and `histogram_delta` as the reference's.
"""
import inspect
import pathlib

import pytest
import torch

import repro.launch.roofline as JR
import repro_torch.launch.roofline as PR
from repro_torch.core import hlo_analysis as PH

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"

BASE = {"status": "ok", "devices": 256, "n_layers": 28, "d_model": 2048,
        "param_count": 1_720_565_760, "active_param_count": 1_720_565_760,
        "bytes_per_param": 2.0, "grad_rs_bytes": 2.0, "mesh": "single",
        "arch": "a", "shape": "s", "trace_flops_global": 1.7e16,
        "collective_bytes": 9.5e10}

CELLS = {
    "dense-train-fsdp": dict(kind="train", family="dense", tp=16, dp=16,
                             eff_devices=256, fsdp=True, microbatch=4,
                             tokens=1_048_576),
    "dense-train-multi": dict(kind="train", family="dense", tp=16, dp=32,
                              eff_devices=512, fsdp=True, microbatch=2,
                              tokens=1_048_576, mesh="multi", devices=512),
    "dense-train-parallel": dict(kind="train", family="dense", tp=16, dp=16,
                                 eff_devices=256, fsdp=True, microbatch=4,
                                 tokens=1_048_576, parallel_block=True),
    "moe-prefill": dict(kind="prefill", family="moe", tp=16, dp=16,
                        eff_devices=256, fsdp=False, tokens=1_048_576,
                        active_param_count=1_280_000_000,
                        param_count=6_920_000_000,
                        cache_bytes_per_device=1.3e9),
    "ssm-decode-long": dict(kind="decode", family="ssm", tp=16, dp=1,
                            eff_devices=16, fsdp=False, tokens=1,
                            cache_bytes_per_device=2.5e7),
    "hybrid-train": dict(kind="train", family="hybrid", tp=16, dp=16,
                         eff_devices=256, fsdp=True, microbatch=8,
                         tokens=1_048_576, n_layers=38),
    "encdec-decode": dict(kind="decode", family="encdec", tp=1, dp=16,
                          eff_devices=16, fsdp=False, tokens=128,
                          cache_bytes_per_device=4.1e9),
    "vlm-prefill-fsdp": dict(kind="prefill", family="vlm", tp=16, dp=16,
                             eff_devices=256, fsdp=True, tokens=1_048_576,
                             mesh="multi", devices=512,
                             cache_bytes_per_device=2.1e10),
    "int8-decode": dict(kind="decode", family="dense", tp=16, dp=16,
                        eff_devices=256, fsdp=False, tokens=128,
                        bytes_per_param=1.0, cache_bytes_per_device=3.7e9),
    "f32-train": dict(kind="train", family="dense", tp=1, dp=1,
                      eff_devices=1, fsdp=True, microbatch=1, tokens=2048,
                      grad_rs_bytes=4.0, mesh="host", devices=1),
}


def _cell(name):
    return {**BASE, "cell": name, **CELLS[name]}


@pytest.mark.parametrize("fn", ["model_flops", "analytic_hbm_bytes",
                                "_tp_ar_per_layer",
                                "analytic_collective_bytes", "load_cells",
                                "markdown_table", "main"])
def test_copied_functions_are_the_references_byte_for_byte(fn):
    assert inspect.getsource(getattr(PR, fn)) == \
        inspect.getsource(getattr(JR, fn))


def test_levers_are_the_references():
    assert PR.LEVERS == JR.LEVERS


@pytest.mark.parametrize("name", list(CELLS))
def test_analytic_functions_equal_the_references(name):
    cell = _cell(name)
    assert PR.model_flops(cell) == JR.model_flops(cell)
    assert PR.analytic_hbm_bytes(cell) == JR.analytic_hbm_bytes(cell)
    assert PR.analytic_collective_bytes(cell) == \
        JR.analytic_collective_bytes(cell)
    assert PR._tp_ar_per_layer(cell) == JR._tp_ar_per_layer(cell)


@pytest.mark.parametrize("name", list(CELLS))
def test_analyze_cell_rescales_the_references_times(name):
    cell = _cell(name)
    got, want = PR.analyze_cell(cell), JR.analyze_cell(cell)
    assert got["compute_s"] == pytest.approx(
        want["compute_s"] * JR.V5E_FLOPS / PR.H100_FLOPS, rel=1e-12)
    assert got["memory_s"] == pytest.approx(
        want["memory_s"] * JR.V5E_HBM / PR.H100_HBM, rel=1e-12)
    parts = JR.analytic_collective_bytes(cell)
    assert want["collective_s"] == pytest.approx(
        parts["ici"] / JR.V5E_ICI_AXIS + parts["pod"] / JR.V5E_DCI,
        rel=1e-12)
    assert got["collective_s"] == pytest.approx(
        parts["ici"] / JR.V5E_ICI_AXIS * JR.V5E_ICI_AXIS / PR.H100_NVLINK
        + parts["pod"] / JR.V5E_DCI * JR.V5E_DCI / PR.H100_POD, rel=1e-12)
    for k in ("model_flops", "hlo_flops_global", "useful_ratio",
              "hbm_bytes_dev", "collective_bytes_dev",
              "hlo_collective_bytes_periter"):
        assert got[k] == want[k], k
    assert got["dominant"] in ("compute", "memory", "collective")
    assert ("note" in got) == (cell["tp"] > PR.NVLINK_DOMAIN)


def test_h100_constants_are_the_datasheets():
    assert (PR.H100_FLOPS, PR.H100_HBM, PR.H100_NVLINK, PR.H100_POD) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert "not measurements" in PR.SPEC_NOTE


def test_no_v5e_constant_in_the_port():
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        for needle in ("V5E", "197e12", "819e9"):
            assert needle not in text, (path, needle)


def _op(target, *args, out=None):
    return PH.RecordedOp(target, args, out)


def test_collective_stats_has_the_references_schema():
    c10 = torch.ops._c10d_functional
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    y = torch.empty((16,), dtype=torch.float32, device="meta")
    ops = [_op(c10.all_reduce.default, x, "sum", "0", out=x),
           _op(c10.wait_tensor.default, x, out=x),
           _op(c10.all_gather_into_tensor.default, y, 4, "0", out=y),
           _op(c10.reduce_scatter_tensor.default, y, "sum", 4, "0", out=y),
           _op(c10.all_to_all_single.default, x, [1], [1], "0", out=x),
           _op(c10.all_reduce.default, y, "sum", "0", out=y),
           _op(torch.ops.aten.mm.default, x, x.T, out=x)]
    stats = PH.collective_stats(ops)
    assert list(stats) == list(PH.COLLECTIVES) == [
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"]
    assert stats == {"all-reduce": {"count": 2, "bytes": 64.0 + 64.0},
                     "all-gather": {"count": 1, "bytes": 64.0},
                     "reduce-scatter": {"count": 1, "bytes": 64.0},
                     "all-to-all": {"count": 1, "bytes": 64.0},
                     "collective-permute": {"count": 0, "bytes": 0.0}}
    assert PH.total_collective_bytes(ops) == 320.0
    assert PH.op_histogram(ops) == {
        "all_reduce": 2, "wait_tensor": 1, "all_gather_into_tensor": 1,
        "reduce_scatter_tensor": 1, "all_to_all_single": 1, "mm": 1}


def test_histogram_delta_is_the_references():
    from repro.core.hlo_analysis import histogram_delta
    a, b = {"mm": 3, "add": 5, "exp": 1}, {"mm": 3, "add": 2, "tanh": 4}
    assert PH.histogram_delta(a, b) == histogram_delta(a, b)
