"""The port's spans on the profiler's clock, and the serving path's own
instruments, on the CPU at the reduced size.

- ``obs.span`` stamps Unix nanoseconds, the clock of ``torch.profiler``'s
  events, and opens a ``record_function`` range of its name while a profiler
  records: the two start and end within 50 us of each other, and a merge of
  the program's trace with the profiler's export
  (``python -m repro_torch.launch.obs``) nests the range inside the span.
- Off (no tracer, no profiler), ``obs.span`` is the shared ``NULL_SPAN``
  and runs no ATen op; a profiler's range is a user range opened without
  one; under a ``make_fx`` trace it opens no range, so a
  block's graph, and the block table's unit of work, are what they are with
  the labels replaced by null contexts.
- A reduced olmoe-1b-7b ``ServeEngine``: ``moe.entries`` and ``moe.slots``
  equal the shape arithmetic of its prefills and decode steps (the block
  tables' ``make_fx`` builds add nothing), the two forward histograms hold one
  observation an iteration of their kind, each iteration's spans are there
  with their attributes, and ``run`` writes no ``serve.*`` value.
"""
import contextlib
import json
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import blocks_lm as B
from repro_torch.core.unit_of_work import trace_graph
from repro_torch.launch import obs as obs_cli
from repro_torch.models import layers as L
from repro_torch.models.moe import capacity
from repro_torch.serve import ServeEngine, SyntheticRequests

# Unix microseconds as a float resolve 0.25 us; a span closes within a
# microsecond of its range, so the nesting is checked to a microsecond
ULP_NS = 1000
ENGINE_SPANS = ("engine.prefill", "engine.prefill.forward",
                "engine.prefill.read", "engine.decode",
                "engine.decode.forward", "engine.decode.read",
                "engine.decode.rows", "profile.add_step")


@contextlib.contextmanager
def traced(trace_dir=None):
    """The process tracer on (streaming to ``trace_dir`` if given), then off
    again."""
    tracer = obs.configure(trace=True, trace_dir=trace_dir)
    try:
        yield tracer
    finally:
        obs.configure(trace=False)


def _spans(tracer, name):
    return [e for e in tracer.events() if e["ph"] == "X" and e["name"] == name]


def _kineto_ranges(prof, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == name and e.device_type().name == "CPU"]


def _warm_up(x):
    """A profile's first ranges pay the profiler's set-up (50-300 us on the
    CPU); the steady ones open within about 10 us of their span."""
    for _ in range(4):
        with obs.span("engine.warm"):
            x * 2


def test_a_span_and_its_profiler_range_share_the_clock():
    """Five spans, each with its range inside it; the median span opens and
    closes within 50 us of its range (one descheduled span on a loaded
    machine does not decide)."""
    x = torch.ones(64)
    with traced() as tracer:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _warm_up(x)
            for _ in range(5):
                with obs.span("engine.probe"):
                    x * 2
    spans = _spans(tracer, "engine.probe")
    ranges = sorted(_kineto_ranges(prof, "engine.probe"))
    assert len(spans) == len(ranges) == 5
    gaps = []
    for sp, (r0, r1) in zip(spans, ranges):
        start_ns, end_ns = sp["ts"] * 1e3, (sp["ts"] + sp["dur"]) * 1e3
        assert start_ns - ULP_NS <= r0 and r1 <= end_ns + ULP_NS, (
            start_ns, end_ns, r0, r1)
        gaps.append((r0 - start_ns, end_ns - r1))
    for side in (0, 1):
        assert statistics.median(g[side] for g in gaps) < 50e3, gaps


def test_the_merged_trace_nests_the_profilers_range_inside_the_span(tmp_path):
    x = torch.ones(64)
    with traced(str(tmp_path / "run")):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _warm_up(x)
            with obs.span("engine.probe", rows=3):
                x * 2
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    merged = tmp_path / "merged.json"
    assert obs_cli.main([str(tmp_path / "run" / "trace.jsonl"),
                         str(tmp_path / "profile.json"),
                         "--merge-out", str(merged)]) == 0
    events = json.loads(merged.read_text())["traceEvents"]
    probe = [e for e in events if e.get("name") == "engine.probe"
             and e.get("ph") == "X"]
    (sp,) = [e for e in probe if e.get("cat") == "span"]
    (rng,) = [e for e in probe if e.get("cat") == "user_annotation"]
    assert sp["args"]["rows"] == 3
    ulp_us = ULP_NS / 1e3
    assert sp["ts"] - ulp_us <= rng["ts"]
    assert rng["ts"] + rng["dur"] <= sp["ts"] + sp["dur"] + ulp_us
    assert rng["ts"] - sp["ts"] < 50                  # microseconds


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_a_span_is_the_null_span_and_runs_no_op():
    assert not obs.enabled()
    assert obs.span("engine.decode", rows=1) is obs.NULL_SPAN
    assert L.scope("nugget_block_moe.route") is obs.NULL_SPAN
    with _OpLog() as log:
        with obs.span("engine.decode") as sp:
            sp.set(rows=2)
        with L.scope("nugget_block_attn"):
            pass
    assert log.ops == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(obs.span("engine.decode"), obs.ProfilerRange)
        with _OpLog() as log:
            with obs.span("engine.decode"):
                pass
        assert log.ops == []           # the range opens without an ATen op
        with _OpLog() as log:          # the control: record_function's ops
            with torch.autograd.profiler.record_function("engine.decode"):
                pass
        assert any("profiler" in op for op in log.ops), log.ops
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "engine.decode"]
    assert len(ranges) == 2 and all(e.is_user_annotation() for e in ranges)


def test_under_a_trace_a_span_opens_no_range():
    def fn(x):
        with obs.span("nugget_block_x"):
            return x * 2
    x = torch.ones(3, device="meta")
    with traced(), profile(activities=[ProfilerActivity.CPU]):
        g = trace_graph(fn, x)
    assert not [n for n in g.graph.nodes if n.op == "call_function"
                and getattr(n.target, "namespace", "") == "profiler"]


def test_timed_observes_with_the_tracer_off(monkeypatch):
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "_metrics", reg)
    for _ in range(3):
        with obs.timed("engine.decode.forward") as sp:
            assert sp is obs.NULL_SPAN
    snap = reg.snapshot()["engine.decode.forward"]
    assert snap["count"] == 3 and snap["min"] >= 0


def _olmoe():
    return reduced(get_config("olmoe-1b-7b"))


def _moe_blocks():
    import dataclasses
    cfg = dataclasses.replace(_olmoe(), attention_impl="chunked")
    from repro_torch.models.model_zoo import build_model
    model = build_model(cfg, device="meta")
    return [B.block_functions(model, ShapeConfig("p", "prefill", 16, 1)),
            B.block_functions(model, ShapeConfig("d", "decode", 32, 3))]


def test_a_moe_models_graphs_are_unchanged_by_the_spans(monkeypatch):
    """Tracer on and a profiler recording: every block's graph has the node
    count it has with the labels replaced by null contexts, and the block
    table of the reduced MoE model is the same."""
    def counts():
        return [{name: len(trace_graph(fn, *args).graph.nodes)
                 for name, fn, args in blocks} for blocks in _moe_blocks()]

    def table():
        from repro_torch.models.model_zoo import build_model
        model = build_model(_olmoe(), device="cpu")
        t = B.build_block_table(model, ShapeConfig("d", "decode", 32, 3),
                                train=False, unit="flops")
        return t.to_json()

    with traced(), profile(activities=[ProfilerActivity.CPU]):
        spanned, spanned_table = counts(), table()
    monkeypatch.setattr(L, "scope", lambda name: contextlib.nullcontext())
    assert spanned == counts()
    assert spanned_table == table()


@pytest.fixture(scope="module")
def served():
    """A reduced olmoe-1b-7b engine's registry deltas and trace over a run
    of 5 requests on 3 rows (the block tables' build measured alone)."""
    cfg = _olmoe()
    reg = obs.metrics()
    names = ("moe.entries", "moe.slots")
    before = {n: reg.value(n) or 0 for n in names}
    eng = ServeEngine(cfg, batch=3, max_seq=40, prefill_len=12,
                      instrument=True, device="cpu")
    built = {n: (reg.value(n) or 0) - before[n] for n in names}
    params = eng.model.init(torch.Generator().manual_seed(0))
    gen = SyntheticRequests(cfg.vocab_size, prompt_len=12, mean_new=6, seed=0)
    hist0 = {k: reg.histogram(f"engine.{k}.forward").count
             for k in ("prefill", "decode")}
    mid = {n: reg.value(n) or 0 for n in names}
    with traced() as tracer:
        stats = eng.run(params, [gen.request(i) for i in range(5)])
    return {"cfg": cfg, "eng": eng, "stats": stats, "built": built,
            "moe": {n: (reg.value(n) or 0) - mid[n] for n in names},
            "hist": {k: reg.histogram(f"engine.{k}.forward").count - hist0[k]
                     for k in ("prefill", "decode")},
            "events": tracer.events(), "tracer": tracer}


def test_the_block_table_build_counts_no_moe_work(served):
    assert served["built"] == {"moe.entries": 0, "moe.slots": 0}


def test_moe_counters_are_the_shape_arithmetic(served):
    cfg, eng = served["cfg"], served["eng"]
    m = cfg.moe
    n_pre = eng.kinds_log.count("prefill")
    n_dec = eng.kinds_log.count("decode")
    assert n_pre == 5 and n_dec > 0
    layers = cfg.n_layers
    entries = layers * (n_pre * 1 * eng.prefill_len * m.top_k
                        + n_dec * eng.batch * 1 * m.top_k)
    slots = layers * (n_pre * 1 * m.n_experts * capacity(eng.prefill_len, m)
                      + n_dec * eng.batch * m.n_experts * capacity(1, m))
    assert served["moe"] == {"moe.entries": entries, "moe.slots": slots}


def test_one_forward_observation_an_iteration(served):
    eng = served["eng"]
    assert served["hist"] == {"prefill": eng.kinds_log.count("prefill"),
                              "decode": eng.kinds_log.count("decode")}


def test_every_iteration_has_its_spans(served):
    eng, events = served["eng"], served["events"]
    n_pre = eng.kinds_log.count("prefill")
    n_dec = eng.kinds_log.count("decode")
    spans = {name: [e for e in events if e["ph"] == "X" and e["name"] == name]
             for name in ENGINE_SPANS}
    for name in ("engine.prefill", "engine.prefill.forward",
                 "engine.prefill.read"):
        assert len(spans[name]) == n_pre, name
    for name in ("engine.decode", "engine.decode.forward",
                 "engine.decode.read", "engine.decode.rows"):
        assert len(spans[name]) == n_dec, name
    assert len(spans["profile.add_step"]) == n_pre + n_dec
    assert sorted(e["args"]["req"] for e in spans["engine.prefill"]) == \
        list(range(5))
    assert all(0 <= e["args"]["slot"] < eng.batch
               for e in spans["engine.prefill"])
    rows = [e["args"]["rows"] for e in spans["engine.decode"]]
    assert all(1 <= r <= eng.batch for r in rows)
    tokens = sum(len(r.output) for r in eng.done)
    assert sum(rows) == tokens - n_pre       # a decoded row gives one token
    # each decode step's phases lie inside it, in order
    for outer, fwd, read, walk in zip(*(spans[n] for n in (
            "engine.decode", "engine.decode.forward", "engine.decode.read",
            "engine.decode.rows"))):
        end = outer["ts"] + outer["dur"]
        assert outer["ts"] <= fwd["ts"] <= read["ts"] <= walk["ts"] <= end
    moe = [e for e in events if e["ph"] == "X"
           and e["name"].startswith("nugget_block_moe.")]
    assert {e["name"] for e in moe} == {
        "nugget_block_moe.route", "nugget_block_moe.dispatch",
        "nugget_block_moe.experts", "nugget_block_moe.combine"}
    attn = {e["name"] for e in events if e["ph"] == "X"
            and e["name"].startswith("nugget_block_attn.")}
    assert attn == {"nugget_block_attn.qkv", "nugget_block_attn.cache_write",
                    "nugget_block_attn.attend", "nugget_block_attn.out"}


def test_run_writes_no_serve_values_and_keeps_its_stats(served):
    assert not [n for n in obs.metrics().names()
                if n in ("serve.requests", "serve.tokens",
                         "serve.tokens_per_s", "serve.latency_s")]
    stats = served["stats"]
    assert set(stats) == {"wall_s", "tokens", "tokens_per_s", "requests",
                          "mean_latency_s", "iterations"}
    assert stats["requests"] == 5
