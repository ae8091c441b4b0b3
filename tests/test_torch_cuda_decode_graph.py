"""The engine's decode step replayed from a CUDA graph (`serve/engine.py`)
against the same engine decoding eagerly, on the card.  These tests need a
CUDA device and nvcc; without one they skip (decided inside the fixture,
never at import).  Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_decode_graph.py

The eager side is the same engine with `graph_captures` answering false, as
it does on the CPU.  On each path both engines serve the same requests from
the same parameters, and the graph's engine must give the same greedy tokens
and, after the run, the same cache (a replay runs the eager step's kernels
in its order; where cuBLAS picks another algorithm under the capture, the
cache may differ by one bf16 unit of its largest value); each decode step
must count the same MoE entries and slots and the same kernel launches (the
capture's counts, counted again at each replay); the graph is replayed on
every decode step but the warm-up and the capture; `reset()` leads to a new
capture and `restore()` keeps the graph, both with the same tokens.  Under
torch.profiler the card runs, replays included, the kernels that the host
counted.  A graph keeps the split counters that K2 and the latent decode
merge by, where a larger launch has grown them since its capture.

The paths: the benchmark's small twins (``olmoe-small``,
``deepseek-v2-lite-small``: f32 at head sizes the kernels do not take, so on
the plain attention), and, on the kernels: olmoe-1b-7b and deepseek-v2-lite
at their widths and a few layers (K1, K2 or the latent decode, the grouped
MoE kernel), qwen3-1.7b reduced with int8 weights and cache, and zamba2-1.2b
at its widths with one group of six Mamba2 layers and the shared attention
(K3, K2, the SSM state in the cache)."""
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BATCH, MAX_SEQ, PREFILL = 4, 128, 64
COUNTS = ("moe.entries", "moe.slots", "moe.grouped_entries")
PATHS = ["olmoe-small", "deepseek-v2-lite-small", "olmoe-1b-7b/2-layers",
         "deepseek-v2-lite/3-layers", "qwen3-1.7b/int8",
         "zamba2-1.2b/7-layers"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph and the kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _twin(name):
    """A small twin's configuration (``portbench/tests/twins``) as the
    benchmark builds it, on the plain attention."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import program
    bench = ROOT / "portbench"
    small = json.loads((bench / "tests" / "twins" / "configs"
                        / f"{name}.json").read_text())
    real = json.loads((bench / "configs" / f"{small['of']}.json").read_text())
    c = {**real, "name": name, **small["overrides"]}
    cell = SimpleNamespace(
        config=c, traffic={"program": {"attention_impl": "reference"}},
        family=lambda: importlib.import_module(
            f"portbench.reference.{c['family']}"))
    return program.arch_config(cell)


def _path(path):
    """(config, parameters) of a path, the weights drawn from seed 0."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.layers import quantize_params
    from repro_torch.models.model_zoo import build_model
    if path in ("olmoe-small", "deepseek-v2-lite-small"):
        cfg = _twin(path)
    elif path == "olmoe-1b-7b/2-layers":
        cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=2)
    elif path == "deepseek-v2-lite/3-layers":
        full = get_config("deepseek-v2-lite")
        cfg = dataclasses.replace(full, n_layers=3, vocab_size=1024,
                                  moe=dataclasses.replace(full.moe,
                                                          n_experts=8))
    elif path == "zamba2-1.2b/7-layers":
        cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=7)
    else:
        base = reduced(get_config("qwen3-1.7b"))
        base = dataclasses.replace(base, attn=dataclasses.replace(
            base.attn, head_dim=64))
        model = build_model(base)
        params = quantize_params(
            model.init(torch.Generator(device="cuda").manual_seed(0)),
            model.axes())
        return dataclasses.replace(base, weight_quant="int8",
                                   cache_quant="int8"), params
    model = build_model(cfg)
    return cfg, model.init(torch.Generator(device="cuda").manual_seed(0))


def _requests(cfg, n_new):
    from repro_torch.serve import Request
    rng = np.random.default_rng(30)
    return [Request(i, rng.integers(0, cfg.vocab_size, PREFILL).astype(
        np.int32), n) for i, n in enumerate(n_new)]


def _counts():
    from repro_torch import obs
    from repro_torch.kernels import build
    reg = obs.metrics()
    out = {n: reg.value(n) or 0 for n in COUNTS + (
        "serve.decode_graph_captures", "serve.decode_graph_replays")}
    out.update(build.launches())
    return out


def _serve(eng, params, reqs):
    """Serve ``reqs`` step by step; the counts each decode step made."""
    for r in reqs:
        eng.submit(r)
    steps = []
    while True:
        before = _counts()
        if not eng.step(params):
            return steps
        if eng.kinds_log[-1] == "decode":
            after = _counts()
            steps.append({n: after[n] - before[n] for n in after})


def _engines(cfg):
    """Two engines of ``cfg``: the first to decode on its graph, the second
    eagerly (under `_eager`)."""
    from repro_torch.serve import ServeEngine
    kw = dict(batch=BATCH, max_seq=MAX_SEQ, prefill_len=PREFILL,
              instrument=True, device="cuda")
    return ServeEngine(cfg, **kw), ServeEngine(cfg, **kw)


def _eager(monkeypatch):
    """The engine's rule answering false, as on the CPU."""
    from repro_torch.serve import engine as E
    monkeypatch.setattr(E, "graph_captures", lambda *a: False)


def _outputs(eng):
    return {r.req_id: list(r.output) for r in eng.done}


def _close(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal, or within one bf16 unit of ``a``'s largest value."""
    if a.equal(b):
        return True
    if not a.is_floating_point():
        return bool((a.long() - b.long()).abs().max() <= 1)
    unit = torch.finfo(torch.bfloat16).eps * a.float().abs().max()
    return bool((a.float() - b.float()).abs().max() <= unit)


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_the_graph_decodes_as_the_eager_step(cuda, path, monkeypatch):
    cfg, params = _path(path)
    n_new = [9, 14, 6, 11, 8]              # a fifth request waits for a slot
    graph, eager = _engines(cfg)
    got = _serve(graph, params, _requests(cfg, n_new))
    with monkeypatch.context() as m:
        _eager(m)
        want = _serve(eager, params, _requests(cfg, n_new))
    assert graph.kinds_log == eager.kinds_log
    assert _outputs(graph) == _outputs(eager)
    for key, t in eager.cache.items():
        assert _close(t, graph.cache[key]), key
    assert len(got) == len(want) >= 8
    # one warm-up step, one capture, then replays; the eager engine none
    assert [s["serve.decode_graph_captures"] for s in got] == \
        [0, 1] + [0] * (len(got) - 2)
    assert [s["serve.decode_graph_replays"] for s in got] == \
        [0, 0] + [1] * (len(got) - 2)
    assert all(s["serve.decode_graph_captures"] == 0
               and s["serve.decode_graph_replays"] == 0 for s in want)
    strip = ("serve.decode_graph_captures", "serve.decode_graph_replays")
    per_step = [{k: v for k, v in s.items() if k not in strip} for s in got]
    assert per_step == [{k: v for k, v in s.items() if k not in strip}
                        for s in want]
    # the step's own kernels, by the replayed launch counts
    expect_moe = cfg.family == "moe" and cfg.compute_dtype == "bfloat16"
    assert all((s["grouped_mlp"] > 0) == expect_moe for s in got), got[-1]
    if cfg.mla is not None and cfg.attention_impl == "cuda":
        assert all(s["mla_decode"] == cfg.n_layers for s in got)


@pytest.mark.cuda
def test_reset_captures_anew_and_restore_keeps_the_graph(cuda, monkeypatch):
    cfg, params = _path("deepseek-v2-lite/3-layers")
    graph, eager = _engines(cfg)
    n_new = [40] * BATCH                    # no row finishes in the window
    first = _serve(graph, params, _requests(cfg, n_new))
    tokens = _outputs(graph)
    assert sum(s["serve.decode_graph_captures"] for s in first) == 1

    # reset: a new cache, a new warm-up and capture, the same tokens
    graph.reset()
    again = _serve(graph, params, _requests(cfg, n_new))
    assert _outputs(graph) == tokens
    assert [s["serve.decode_graph_captures"] for s in again][:3] == [0, 1, 0]

    # restore: the engine's state of a few steps back, written in place
    # into the graph's buffers, then the same steps again on the same graph;
    # against the eager engine over the same steps
    def steps(eng, n):
        out = []
        for _ in range(n):
            before = _counts()["serve.decode_graph_captures"]
            assert eng.step(params) and eng.kinds_log[-1] == "decode"
            out.append((eng.last_token.clone(),
                        _counts()["serve.decode_graph_captures"] - before))
        return out

    def prefilled(eng):
        eng.reset()
        for r in _requests(cfg, n_new):
            eng.submit(r)
        while eng.queue:
            assert eng.step(params)
        return eng

    prefilled(graph)
    steps(graph, 4)                         # warm-up, capture, 2 replays
    snap = graph.snapshot()
    ahead = steps(graph, 5)
    graph.restore(snap)
    back = steps(graph, 5)
    assert [c for _, c in ahead] == [0] * 5
    assert [c for _, c in back] == [0] * 5
    for (a, _), (b, _) in zip(ahead, back):
        assert a.equal(b)
    with monkeypatch.context() as m:
        _eager(m)
        prefilled(eager)
        steps(eager, 4)
        ref = steps(eager, 5)
    for (a, _), (b, _) in zip(ahead, ref):
        assert a.equal(b)


@pytest.fixture(scope="module")
def smoke(cuda):
    """`chip_smoke.py`: its kernels' count from the card's events
    (`on_device`) and a serving run's launches (`expected_launches`)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["olmoe-1b-7b/2-layers",
                                  "deepseek-v2-lite/3-layers"])
def test_the_replays_run_the_kernels_that_the_host_counts(smoke, path):
    from repro_torch.kernels import build
    cfg, params = _path(path)
    n_new = [9, 14, 6, 11, 8]
    warm, _ = _engines(cfg)
    _serve(warm, params, _requests(cfg, n_new))   # loads every kernel
    decodes = warm.kinds_log.count("decode")
    want = smoke.expected_launches(cfg, warm.kinds_log.count("prefill"),
                                   decodes)

    def served():
        graph, _ = _engines(cfg)
        before = _counts()
        _serve(graph, params, _requests(cfg, n_new))
        after = _counts()
        return graph, {k: after[k] - before[k] for k in after}

    (graph, counted), events, _ = smoke.on_device(
        served, smoke.expected_events(want))
    assert graph.kinds_log == warm.kinds_log
    assert counted["serve.decode_graph_replays"] == decodes - 2
    assert {k: counted[k] for k in build.KERNELS} == want
    assert events == smoke.expected_events(want)
    assert want["grouped_mlp"] > 0


@pytest.mark.cuda
def test_a_graph_keeps_its_split_counters_when_a_larger_launch_grows_them(
        cuda):
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as FD
    kv, hd = 8, 64
    tile = build.load().rt_flash_decode_tile()
    s = 4 * tile                                   # four splits of a tile

    def inputs(b):
        g = torch.Generator(device="cuda").manual_seed(b)
        q, k, v = (torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
                   for shape in ((b, 1, kv, hd), (b, s, kv, hd),
                                 (b, s, kv, hd)))
        return q, k, v, torch.full((b,), s, dtype=torch.int32, device="cuda")

    def decode(q, k, v, lengths):
        return FD.launch_with_split(q, k, v, lengths, group=1, window=-1,
                                    cap=0.0, n_splits=s // tile, chunk=tile)

    small = inputs(2)
    dev = small[0].device                          # the counters' key
    want = decode(*small)                          # eager: sets the counters
    n0 = FD.split_counters(dev, 0).numel()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode(*small)
    out.zero_()
    graph.replay()
    assert out.equal(want)
    decode(*inputs(n0 // kv + 1))                  # more counters than n0
    assert FD.split_counters(dev, 0).numel() > n0
    # blocks of the old counters' size, at a value no split count reaches:
    # were the old counters freed, the allocator would hand their memory out
    taken = [torch.full((n0,), 1 << 20, dtype=torch.int32, device="cuda")
             for _ in range(64)]
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert out.equal(want)
    del taken
