"""Zero-overhead marker location on the port (paper §III-D2), on the CPU at
the reduced size, mirroring tests/test_marker_labels.py: the blocks carry the
reference's ``named_scope`` labels as `layers.scope` ranges, and
`hlo_analysis.find_scope_labels` locates each block's ops by label in a
recorded profile of one loss call (ATen ops here; kernels on the card).

A range exists only while a profiler records and no trace runs: outside a
profile, and inside any ``make_fx`` trace (with or without a profiler), it
adds no op, so no node of a block's graph lies in the ``profiler`` namespace
and every block's unit of work (`trace_cost`) is what it is with the label
replaced by a null context."""
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import blocks_lm as B
from repro_torch.core import hlo_analysis as H
from repro_torch.core.unit_of_work import trace_cost, trace_graph
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model

LABELS = {"qwen3-1.7b": ("nugget_block_attn", "nugget_block_mlp"),
          "olmoe-1b-7b": ("nugget_block_attn", "nugget_block_moe"),
          "mamba2-780m": ("nugget_block_mamba",),
          "deepseek-v2-lite": ("nugget_block_attn", "nugget_block_mlp",
                               "nugget_block_moe")}
ALL = sorted({label for v in LABELS.values() for label in v})


def _loss_call(arch):
    cfg = reduced(get_config(arch))
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}

    @torch.no_grad()
    def loss():
        return m.loss(params, batch)[0]
    return loss


@pytest.fixture(scope="module", params=list(LABELS))
def recorded(request):
    arch = request.param
    loss = _loss_call(arch)
    loss()
    return arch, H.profile_call(loss, cuda=False)


def test_block_markers_locatable(recorded):
    arch, prof = recorded
    for label in ALL:
        found = H.find_scope_labels(prof, label)
        if label in LABELS[arch]:
            assert found, (arch, label)
            assert all(not n.startswith("aten::") for n in found)
        else:
            assert found == [], (arch, label, found[:5])
    assert H.find_scope_labels(prof, "nugget_block_none") == []


def test_labelled_ops_are_the_blocks_ops(recorded):
    """The labels split the call's ops by block: an attention block holds
    the attention's products, an MLP block the MLP's, and the embedding and
    the head lie outside every label."""
    arch, prof = recorded
    per = {label: H.find_scope_labels(prof, label) for label in LABELS[arch]}
    everything = H.cpu_op_histogram(prof)
    assert sum(len(v) for v in per.values()) < sum(everything.values())
    if arch == "qwen3-1.7b":
        assert "einsum" in per["nugget_block_attn"]        # the projections
        assert "matmul" in per["nugget_block_mlp"]
    if arch == "olmoe-1b-7b":
        assert "bmm" in per["nugget_block_moe"]            # the experts
    if arch == "mamba2-780m":
        assert "cumsum" in per["nugget_block_mamba"]
    if arch == "deepseek-v2-lite":   # the leading dense layer, then experts
        assert "matmul" in per["nugget_block_mlp"]
        assert "bmm" in per["nugget_block_moe"]


def _profiler_nodes(graph) -> list:
    return [n for n in graph.graph.nodes if n.op == "call_function"
            and getattr(n.target, "namespace", "") == "profiler"]


def _blocks(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              attention_impl="chunked", ssm_impl="chunked")
    model = build_model(cfg, device="meta")
    return B.block_functions(model, ShapeConfig("x", "prefill", 16, 2))


@pytest.mark.parametrize("arch", list(LABELS))
@pytest.mark.parametrize("recording", [False, True])
def test_no_profiler_node_in_any_block_trace(arch, recording):
    ctx = (profile(activities=[ProfilerActivity.CPU]) if recording
           else contextlib.nullcontext())
    with ctx:
        for name, fn, args in _blocks(arch):
            assert not _profiler_nodes(trace_graph(fn, *args)), name


def test_a_plain_range_would_be_traced():
    """The control: a ``record_function`` range that does not check for a
    trace puts ``profiler`` nodes into a ``make_fx`` graph while a profiler
    records, which is what `layers.scope` avoids."""
    def fn(x):
        with torch.autograd.profiler.record_function("nugget_block_x"):
            return x * 2
    x = torch.ones(3, device="meta")
    with profile(activities=[ProfilerActivity.CPU]):
        assert _profiler_nodes(trace_graph(fn, x))
        assert not _profiler_nodes(trace_graph(
            lambda x: _scoped_double(x), x))


def _scoped_double(x):
    with L.scope("nugget_block_x"):
        return x * 2


@pytest.mark.parametrize("arch", list(LABELS))
def test_block_costs_unchanged_by_the_labels(arch, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        labelled = {name: trace_cost(fn, *args)
                    for name, fn, args in _blocks(arch)}
    monkeypatch.setattr(L, "scope", lambda name: contextlib.nullcontext())
    bare = {name: trace_cost(fn, *args) for name, fn, args in _blocks(arch)}
    assert labelled == bare


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", list(LABELS))
def test_labels_add_no_op_outside_a_profile(arch, monkeypatch):
    """The same loss call runs the same ATen ops with the labels on and
    off, outside a profile."""
    loss = _loss_call(arch)
    runs = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(L, "scope",
                                lambda name: contextlib.nullcontext())
        with _OpLog() as log:
            loss()
        runs[on] = log.ops
    assert runs[True] == runs[False] and runs[True]
    assert not any("profiler" in op for op in runs[True])
