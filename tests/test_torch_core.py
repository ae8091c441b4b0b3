"""Host side of the sampling framework in the port: the numpy-only interval
analysis is a copy and must give byte-equal profiles; the block table is
traced on the ATen graph instead of the jaxpr and must keep the reference's
block names, step program and matrix-product FLOPs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import SSM_ARCHS
from repro.configs import get_config as jget, reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core import blocks_lm as JB
from repro.core import intervals as JI
from repro.core import registry as JR
from repro.core.unit_of_work import _as_jaxpr, _sub_jaxprs, eqn_flops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import blocks_lm as PB
from repro_torch.core import intervals as PI
from repro_torch.core import registry as PR
from repro_torch.core.unit_of_work import (IRCost, graph_cost, matmul_flops,
                                           trace_cost, trace_graph)
from repro_torch.models.model_zoo import build_model

import torch


def _table(mod):
    pre = mod.BlockTable(
        [mod.BlockDef("embed", 3.0, 0.0), mod.BlockDef("attn", 120.0, 5e3),
         mod.BlockDef("mlp", 260.0, 9e3), mod.BlockDef("head", 75.0, 2e3),
         mod.BlockDef("expert_tok_0", 0.0, 0.0, virtual=True,
                      dyn_key="expert_tokens", dyn_index=0)],
        [mod.Segment((0,), 1), mod.Segment((1, 2), 3), mod.Segment((3,), 1)])
    dec = mod.BlockTable(
        [mod.BlockDef("embed", 1.0, 0.0), mod.BlockDef("attn", 17.0, 5e2),
         mod.BlockDef("mlp", 31.0, 9e2), mod.BlockDef("head", 9.0, 2e2)],
        [mod.Segment((0,), 1), mod.Segment((1, 2), 3), mod.Segment((3,), 1)])
    return mod.merge_tables({"prefill": pre, "decode": dec})


def _stream(n=300):
    rng = np.random.default_rng(9)
    steps = []
    for i in range(n):
        kind = "prefill" if rng.random() < 0.2 else "decode"
        dyn = ({"expert_tokens": rng.integers(0, 50, size=4)}
               if kind == "prefill" else None)
        steps.append((kind, dyn))
    return steps


def _profile_arrays(prof):
    out = {
        "bbv": prof.bbv_matrix(),
        "stamps": np.stack([iv.stamps for iv in prof.intervals]),
        "hits": np.stack([iv.hits_at_stamp for iv in prof.intervals]),
        "bounds": np.asarray([[iv.start_uow, iv.end_uow, iv.start_step,
                               iv.end_step, iv.end_marker.block,
                               iv.end_marker.hits, iv.end_marker.uow]
                              for iv in prof.intervals]),
        "totals": np.asarray([prof.total_uow, prof.n_steps, prof.step_uow,
                              prof.interval_uow]),
    }
    for k, v in sorted(prof.dyn_history.items()):
        out["dyn_" + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("defer", [False, True])
def test_interval_builder_profiles_are_byte_equal(defer):
    jt, pt = _table(JR), _table(PR)
    assert jt.to_json() == pt.to_json()
    iu = 2.5 * jt.step_uow("decode")
    jb = JI.IntervalBuilder(jt, iu, defer=defer)
    pb = PI.IntervalBuilder(pt, iu, defer=defer)
    for kind, dyn in _stream():
        jb.add_step(dyn, kind=kind)
        pb.add_step(dyn, kind=kind)
    ja, pa = _profile_arrays(jb.finalize()), _profile_arrays(pb.finalize())
    assert ja.keys() == pa.keys() and len(ja["bbv"]) > 10
    for key in ja:
        assert ja[key].dtype == pa[key].dtype, key
        assert ja[key].tobytes() == pa[key].tobytes(), key


def _jax_dot_flops(jaxpr, contracting_only: bool = False) -> float:
    """FLOPs of the dot_general equations alone, by the reference's own
    `eqn_flops`, recursing into sub-jaxprs as `jaxpr_cost` does.
    ``contracting_only`` leaves out dot_generals that contract nothing: the
    elementwise products into which `jnp.einsum` splits a three-operand
    einsum (ATen writes them as `mul`)."""
    total = 0.0
    for eqn in _as_jaxpr(jaxpr).eqns:
        subs, _ = _sub_jaxprs(eqn)
        for sj, mult in subs:
            total += mult * _jax_dot_flops(sj, contracting_only)
        if not subs and eqn.primitive.name == "dot_general":
            (lhs_c, _), _ = eqn.params["dimension_numbers"]
            if lhs_c or not contracting_only:
                total += eqn_flops(eqn)
    return total


def _jax_block_jaxprs(model, shape):
    """The reference's per-block traces (as `build_block_table` makes them)."""
    cfg, dims = model.cfg, model.dims
    dt = jnp.float32
    b = max(shape.global_batch, 1)
    s = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model
    x = jax.ShapeDtypeStruct((b, s, d), dt)
    pos = jax.ShapeDtypeStruct((b, s), jnp.int32)
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    lp = JB._spec_struct(JT.layer_specs(cfg, dims), dt)
    emb = {"embedding": jax.ShapeDtypeStruct((dims.vocab_pad, d), dt)}
    return {
        "embed": jax.make_jaxpr(lambda p, t: JL.embed_lookup(p, t, dt))(emb, toks),
        "attn": jax.make_jaxpr(
            lambda p, xx, pp: JT._attn_block(p, cfg, dims, xx, pp,
                                             jnp.int32(-1), plus_one=False,
                                             aux={})[0])(lp, x, pos),
        "mlp": jax.make_jaxpr(
            lambda p, xx: JT._mlp_block(p, cfg, xx, plus_one=False,
                                        aux={}))(lp, x),
    }


@pytest.mark.parametrize("kind,seq,batch", [("prefill", 16, 1),
                                            ("decode", 64, 3)])
def test_block_table_matches_the_reference(kind, seq, batch):
    # the JAX side is traced with attention_impl="reference": like the plain
    # version that the port's trace goes through, it holds the two attention
    # products as whole matrix products (a pallas_call hides them in a kernel
    # body that is counted once, whatever its grid)
    jcfg = dataclasses.replace(jreduced(jget("qwen3-1.7b")),
                               attention_impl="reference")
    jmodel = jbuild(jcfg)
    pmodel = build_model(reduced(get_config("qwen3-1.7b")), device="cpu")
    jtab = JB.build_block_table(jmodel, JShape("x", kind, seq, batch),
                                train=False, unit="flops")
    ptab = PB.build_block_table(pmodel, ShapeConfig("x", kind, seq, batch),
                                train=False, unit="flops")
    assert ptab.names == jtab.names == ["embed", "attn", "mlp", "head"]
    assert [dataclasses.asdict(s) for s in ptab.program] == \
        [dataclasses.asdict(s) for s in jtab.program]

    jaxprs = _jax_block_jaxprs(jmodel, JShape("x", kind, seq, batch))
    graphs = {name: trace_graph(fn, *args) for name, fn, args
              in PB.block_functions(pmodel, ShapeConfig("x", kind, seq, batch))}
    for name in ("embed", "attn", "mlp"):
        assert matmul_flops(graphs[name]) == _jax_dot_flops(jaxprs[name]), name
    assert matmul_flops(graphs["attn"]) > 0

    # FLOP-weighted block costs: the matrix products are equal; elementwise
    # functions decompose differently in ATen than in the jaxpr (softmax,
    # rsqrt, silu are single ATen ops), so the totals agree within 10 %
    # The embed block is a pure gather, free in both IRs: the reference's few
    # units are the index clamp on the [b, s] token ids.
    for jb, pb in zip(jtab.blocks, ptab.blocks):
        assert pb.cost_ops >= 1.0
        if jb.name == "embed":
            assert abs(pb.cost_ops - jb.cost_ops) <= 3 * batch * seq
        else:
            assert pb.cost_ops == pytest.approx(jb.cost_ops, rel=0.10), jb.name


def _ssm_pair(arch, **replace):
    jcfg = dataclasses.replace(jreduced(jget(arch), **SSM_ARCHS[arch]),
                               attention_impl="reference")
    pcfg = dataclasses.replace(reduced(get_config(arch), **SSM_ARCHS[arch]),
                               **replace)
    return jbuild(jcfg), build_model(pcfg, device="cpu")


def _jax_ssm_jaxprs(model, shape):
    cfg, dims = model.cfg, model.dims
    dt = jnp.float32
    b = max(shape.global_batch, 1)
    s = shape.seq_len if shape.kind != "decode" else 1
    x = jax.ShapeDtypeStruct((b, s, cfg.d_model), dt)
    pos = jax.ShapeDtypeStruct((b, s), jnp.int32)
    lp = JB._spec_struct(JT.layer_specs(cfg, dims), dt)
    out = {"mamba": jax.make_jaxpr(
        lambda p, xx: JT.ssm_layer(p, cfg, xx)[0])(lp, x)}
    if cfg.family == "hybrid":
        sh = JB._spec_struct(JT.shared_attn_specs(cfg, dims), dt)
        out["shared_attn"] = jax.make_jaxpr(
            lambda p, xx, pp: JT._shared_attn_block(
                {"shared_attn": p}, cfg, dims, xx, pp)[0])(sh, x, pos)
    return out


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
@pytest.mark.parametrize("kind,seq,batch", [("prefill", 40, 1),
                                            ("decode", 64, 3)])
def test_ssm_block_table_matches_the_reference(arch, kind, seq, batch):
    """Both sides trace the same algorithm (`ssd_chunked`; the reference's
    attention with `attention_impl="reference"`, the port's through the
    kernels' plain versions): the same block names, step program and
    matrix-product FLOPs per block, and FLOP-weighted costs within 10 %."""
    jmodel, pmodel = _ssm_pair(arch, ssm_impl="chunked")
    jshape = JShape("x", kind, seq, batch)
    pshape = ShapeConfig("x", kind, seq, batch)
    jtab = JB.build_block_table(jmodel, jshape, train=False, unit="flops")
    ptab = PB.build_block_table(pmodel, pshape, train=False, unit="flops")
    want = ["embed", "mamba"] + (["shared_attn"] if "zamba" in arch else []) \
        + ["head"]
    assert ptab.names == jtab.names == want
    assert [dataclasses.asdict(s) for s in ptab.program] == \
        [dataclasses.asdict(s) for s in jtab.program]

    jaxprs = _jax_ssm_jaxprs(jmodel, jshape)
    graphs = {name: trace_graph(fn, *args) for name, fn, args
              in PB.block_functions(pmodel, pshape)}
    for name, jaxpr in jaxprs.items():
        assert matmul_flops(graphs[name]) == \
            _jax_dot_flops(jaxpr, contracting_only=True), name
        assert matmul_flops(graphs[name]) > 0
    for jb, pb in zip(jtab.blocks, ptab.blocks):
        if jb.name not in ("embed",):
            assert pb.cost_ops == pytest.approx(jb.cost_ops, rel=0.10), jb.name


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
def test_ssm_block_table_with_the_kernel_path(arch):
    """With the default `ssm_impl="cuda"` the trace goes through K3's plain
    version and `ops.ssd`: the same names and program as the reference, and
    the mamba block's matrix-product FLOPs near those of `ssd_chunked` (the
    inter-chunk term is skipped for the first chunk, whose state is 0)."""
    jmodel, pmodel = _ssm_pair(arch)
    assert pmodel.cfg.ssm_impl == "cuda"
    shape = ShapeConfig("x", "prefill", 40, 1)
    jtab = JB.build_block_table(jmodel, JShape("x", "prefill", 40, 1),
                                train=False, unit="flops")
    ptab = PB.build_block_table(pmodel, shape, train=False, unit="flops")
    assert ptab.names == jtab.names
    assert [dataclasses.asdict(s) for s in ptab.program] == \
        [dataclasses.asdict(s) for s in jtab.program]
    chunked = build_model(dataclasses.replace(pmodel.cfg, ssm_impl="chunked"),
                          device="cpu")
    fl = {}
    for name, m in (("cuda", pmodel), ("chunked", chunked)):
        fns = {n: (fn, args) for n, fn, args in PB.block_functions(m, shape)}
        fn, args = fns["mamba"]
        fl[name] = matmul_flops(trace_graph(fn, *args))
    assert 0.8 < fl["cuda"] / fl["chunked"] <= 1.0, fl


def test_trace_cost_counts_products_and_free_ops():
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 5), device="meta")

    def fn(x, y):
        z = (x @ y).reshape(5, 4).t()          # product + two free views
        return torch.relu(z) + 1.0             # two elementwise ops

    cost = trace_cost(fn, a, b)
    assert isinstance(cost, IRCost)
    assert cost.flops == 2 * 4 * 5 * 8 + 20 + 20
    assert cost.ops >= 4 and cost.bytes > 0 and cost.unbounded_loops == 0
    gm = trace_graph(fn, a, b)
    assert matmul_flops(gm) == 2 * 4 * 5 * 8
    assert graph_cost(gm).flops == cost.flops
    both = cost + cost.scale(2.0)
    assert both.flops == 3 * cost.flops and both.ops == 3 * cost.ops


def test_full_width_table_allocates_nothing():
    """Tracing at the published widths works on meta tensors alone."""
    model = build_model(get_config("qwen3-1.7b"), device="cpu")
    tab = PB.build_block_table(model, ShapeConfig("p", "prefill", 256, 1),
                               train=False, unit="flops")
    d, f, s = 2048, 6144, 256
    mlp = tab.blocks[tab.id_of("mlp")]
    assert mlp.cost_flops >= 3 * 2 * s * d * f
    assert tab.step_uow() > 28 * 3 * 2 * s * d * f
