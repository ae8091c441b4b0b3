"""The benchmark's readers of the metrics that the port's own instruments
feed (``portbench/metrics/``: the engine's forward histograms, the MoE
block's counters): nothing on an empty registry, and the right numbers on
one filled by hand."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch import obs

BENCH = Path(__file__).resolve().parents[1] / "portbench"

DISPATCH = {"engine.decode_dispatch_ms.serve": "engine.decode.forward",
            "engine.prefill_dispatch_ms.serve": "engine.prefill.forward",
            "attn.mla_decode_issue_ms.serve": "attn.mla.decode"}
SLOT_FILL = "model_step.moe_slot_fill.serve"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def registry(monkeypatch):
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "_metrics", reg)
    return reg


@pytest.mark.parametrize("name", sorted(DISPATCH) + [SLOT_FILL])
def test_an_empty_registry_reads_nothing(registry, name):
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_is_the_median_of_the_recent_window(registry, name):
    # 600 observations: the first 88 (the warm-up's, say) fall out of the
    # window of 512, whose median is 0.020 s
    for _ in range(88):
        registry.observe(DISPATCH[name], 5.0)
    for i in range(512):
        registry.observe(DISPATCH[name], 0.010 if i < 200 else 0.020)
    assert reader(name)({}) == pytest.approx(20.0)
    other = next(n for n in DISPATCH if n != name)
    assert reader(other)({}) is None


def test_slot_fill_is_the_share_of_filled_rows(registry):
    # chat's shapes: 1k prefills of 8 192 entries over 10 240 rows, decode
    # steps of 256 rows of 8 entries over 131 072, 16 layers each
    prefills, decodes = 10, 7
    registry.count("moe.entries", 16 * (prefills * 8192 + decodes * 2048))
    registry.count("moe.slots", 16 * (prefills * 10240 + decodes * 131072))
    want = 100.0 * (10 * 8192 + 7 * 2048) / (10 * 10240 + 7 * 131072)
    assert reader(SLOT_FILL)({}) == pytest.approx(want)
    assert 9.0 < want < 11.0


def test_slot_fill_needs_both_counters(registry):
    registry.count("moe.entries", 8)
    assert reader(SLOT_FILL)({}) is None
