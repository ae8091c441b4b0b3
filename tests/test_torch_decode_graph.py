"""The decode step's CUDA graph (`serve/engine.py`) where it can be checked
without a card: the counts that a captured step made, counted again at each
replay (`obs.CountRecord`); a timed span that ends under a capture, which
observes nothing; the rule that decides where the engine captures
(`graph_captures`: a CUDA device, greedy, plain tensors; the CPU, meta and
fake tensors, DTensors and sampling stay eager); and the benchmark's reader
of the graph's share of the decode steps.  The graph itself runs only on the
card: `tests/test_torch_cuda_decode_graph.py`."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_port import run_ranks
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import graph_captures

BENCH = Path(__file__).resolve().parents[1] / "portbench"
SHARE = "engine.decode_graph_share.serve"
CUDA = torch.device("cuda")


@pytest.fixture
def registry(monkeypatch):
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "_metrics", reg)
    return reg


def test_counts_made_under_a_capture_are_counted_again_at_each_replay(
        registry):
    from repro_torch.kernels import build
    registry.count("moe.entries", 5)             # before: not recorded
    registry.count("kernels.mla_decode.launches", 7)
    registry.record("serve.gauge", 1.0)
    with obs.CountRecord() as rec:
        registry.count("moe.entries", 16)
        registry.count("moe.slots", 32)
        registry.count("moe.slots", 32)
        registry.record("serve.gauge", 2.0)      # a gauge is not a count
        for _ in range(3):
            build.count_launch("flash_decode")   # a wrapper's launch
    assert rec.counts == {"moe.entries": 16, "moe.slots": 64,
                          "kernels.flash_decode.launches": 3}
    for _ in range(2):
        rec.replay()
    assert registry.value("moe.entries") == 5 + 3 * 16
    assert registry.value("moe.slots") == 3 * 64
    launches = build.launches()
    assert (launches["flash_decode"], launches["mla_decode"]) == (3 * 3, 7)
    assert registry.value("serve.gauge") == 2.0


def test_a_record_of_nothing_replays_nothing(registry):
    with obs.CountRecord() as rec:
        pass
    rec.replay()
    assert rec.counts == {}
    assert registry.names() == []


def _capture(monkeypatch, on: bool):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: on)


def test_a_timed_span_under_a_capture_observes_nothing(registry,
                                                       monkeypatch):
    assert not obs.capturing()                  # no card: never
    _capture(monkeypatch, True)
    assert obs.capturing()
    with obs.timed("attn.mla.decode"):
        pass
    assert registry.snapshot() == {}
    _capture(monkeypatch, False)
    with obs.timed("attn.mla.decode"):
        pass
    assert registry.snapshot()["attn.mla.decode"]["count"] == 1


def _tree():
    params = {"final_norm": {"scale": torch.ones(4)},
              "layers": [{"w": torch.nn.Parameter(torch.zeros(4, 4))}],
              "n": 3}
    cache = {"k": torch.zeros(2, 8), "length": torch.zeros(2, dtype=torch.int32)}
    return params, cache


def test_the_rule_captures_greedy_plain_tensors_on_a_cuda_device():
    params, cache = _tree()
    assert graph_captures(CUDA, 0.0, params, cache)
    assert not graph_captures(torch.device("cpu"), 0.0, params, cache)
    assert not graph_captures(torch.device("meta"), 0.0, params, cache)
    assert not graph_captures(CUDA, 0.7, params, cache)


def test_the_rule_leaves_fake_tensors_eager():
    params, cache = _tree()
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.zeros(2, 8))
        assert not graph_captures(CUDA, 0.0, params, cache)   # under a trace
    assert not graph_captures(CUDA, 0.0, params, dict(cache, k=fake))


def _dtensor_rule(rank, world, init_file):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    params, cache = _tree()
    sharded = dict(params, final_norm={"scale": DTensor.from_local(
        params["final_norm"]["scale"], mesh, [Replicate()], run_check=False)})
    k = DTensor.from_local(cache["k"], mesh, [Replicate()], run_check=False)
    return (graph_captures(CUDA, 0.0, params, cache),
            graph_captures(CUDA, 0.0, sharded, cache),
            graph_captures(CUDA, 0.0, params, dict(cache, k=k)))


def test_the_rule_leaves_dtensors_eager():
    ((plain, params, cache),) = run_ranks(_dtensor_rule, 1, timeout=180)
    assert (plain, params, cache) == (True, False, False)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_an_engine_on_the_cpu_decodes_eagerly(registry, temperature):
    cfg = reduced(get_config("qwen3-1.7b"))
    eng = ServeEngine(cfg, batch=2, max_seq=32, prefill_len=8, device="cpu",
                      instrument=False, temperature=temperature)
    params = eng.model.init(torch.Generator().manual_seed(0))
    last = eng.last_token
    rng = np.random.default_rng(0)
    eng.run(params, [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(
        np.int32), 4) for i in range(3)])
    decodes = eng.kinds_log.count("decode")
    assert decodes >= 4
    assert registry.value("serve.decode_iters") == decodes
    assert registry.value("serve.decode_graph_captures") is None
    assert registry.value("serve.decode_graph_replays") is None
    assert eng._graph is None and not eng._graph_on
    assert eng.last_token is last                # written in place


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_graph_share_reads_nothing_without_its_counter(registry):
    assert _reader(SHARE)({}) is None
    registry.count("serve.decode_iters", 40)    # the parent: no replays
    assert _reader(SHARE)({}) is None


def test_the_graph_share_is_the_replays_over_the_decode_steps(registry):
    # a warm-up step and a capture, then 398 replays
    registry.count("serve.decode_iters", 400)
    registry.count("serve.decode_graph_captures", 1)
    registry.count("serve.decode_graph_replays", 398)
    assert _reader(SHARE)({}) == pytest.approx(99.5)
