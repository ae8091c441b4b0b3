"""The port's MoE family against the JAX package's, on the CPU at the reduced
size (f32): reduced olmoe-1b-7b (4 experts, top-2) and reduced
llama4-scout-17b-a16e (4 experts, top-1 and a shared expert), the JAX
parameters converted leaf by leaf, inputs made with numpy from a seed.

`route`, `capacity`, `dispatch_indices` and `moe_mlp` one by one (slots,
keep masks and the router statistics equal, a case that drops tokens
included), the whole model's forward, loss (with the router term) and
gradients, prefill and decode, the serve engine, the block table, the router
jitter, and the port's twin of `tests/test_system.py`'s MoE checks.
Tolerance 2e-4, the reference's own cross-implementation tolerance
(tests/test_models.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import model_pair, to_np
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core import blocks_lm as JB
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jbuild
from repro.serve import ServeEngine as JEngine
from repro.serve import SyntheticRequests as JRequests
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import blocks_lm as PB
from repro_torch.core.unit_of_work import matmul_flops, trace_graph
from repro_torch.models import layers as L
from repro_torch.models import moe as PM
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine, SyntheticRequests
from repro_torch.train import Trainer
from repro_torch.train.state import step_generator
from test_torch_core import _jax_dot_flops
from test_torch_train import _batch, _flat, _rel, _train_cfg

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
SHIFT = np.float32(0.5)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param)


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _layer0(jp, pp):
    """Layer 0's MoE parameters of both packages."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            L.tree_index(pp["layers"]["moe"], 0))


def _skewed(jcfg, pcfg, jmoe, pmoe, capacity_factor=0.5):
    """Configs with a low capacity factor and parameters whose router sends
    most tokens of a positive mean (`SHIFT`) to expert 0, so that experts
    overflow and tokens drop."""
    jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    pc = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=capacity_factor))
    k = np.asarray(jmoe["router"]["kernel"]).copy()
    k[:, 0] += 0.5
    jmoe = dict(jmoe, router={"kernel": jnp.asarray(k)})
    pmoe = dict(pmoe, router={"kernel": torch.from_numpy(k)})
    return jc, pc, jmoe, pmoe


# ---------------------------------------------------------------------------
# the MoE layer, piece by piece
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [1, 7, 16, 40, 256, 1000])
@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
def test_capacity_matches_the_reference(arch, seq, factor):
    for jcfg, pcfg in ((jget(arch), get_config(arch)),
                       (jreduced(jget(arch)), reduced(get_config(arch)))):
        jm = dataclasses.replace(jcfg.moe, capacity_factor=factor)
        pm = dataclasses.replace(pcfg.moe, capacity_factor=factor)
        assert PM.capacity(seq, pm) == JM.capacity(seq, jm)
        assert PM.capacity(seq, pm) % 8 == 0


def test_capacity_at_the_serving_shapes():
    m = get_config("olmoe-1b-7b").moe
    assert PM.capacity(1, m) == 8               # a decode step, padded to 8
    assert PM.capacity(256, m) == 40            # a prefill of 256


@pytest.mark.parametrize("skew", [False, True])
def test_route_matches_the_reference(pair, skew):
    jcfg, _, jp, pcfg, _, pp = pair
    jmoe, pmoe = _layer0(jp, pp)
    x = _x(pcfg, 2, 12)
    if skew:
        jcfg, pcfg, jmoe, pmoe = _skewed(jcfg, pcfg, jmoe, pmoe)
        x = x + SHIFT
    je, jg, ja = JM.route(jmoe["router"], jnp.asarray(x), jcfg.moe)
    pe, pg, pa = PM.route(pmoe["router"], torch.from_numpy(x), pcfg.moe)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_allclose(to_np(pg), to_np(jg), **TOL)
    assert set(pa) == set(ja) == {"router_aux_loss", "router_logits_max"}
    for key in pa:
        np.testing.assert_allclose(to_np(pa[key]), to_np(ja[key]), **TOL)


def _top_e(kind, b, s, k, e, seed):
    """Expert ids [B, S, k]: distinct per token as top-k makes them
    (`random`), or every token's first choice expert 0 (`one_expert`)."""
    rng = np.random.default_rng(seed)
    out = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)])
                    for _ in range(b)]).astype(np.int32)
    if kind == "one_expert":
        out[..., 0] = 0
        if k > 1:
            out[..., 1] = rng.integers(1, e, size=(b, s))
    return out


@pytest.mark.parametrize("kind,b,s,k,e,cap", [
    ("random", 2, 12, 2, 4, 8),        # no drop
    ("random", 3, 40, 2, 4, 8),        # drops in every expert
    ("one_expert", 2, 24, 2, 4, 8),    # expert 0 overflows
    ("one_expert", 1, 33, 1, 16, 8),   # top-1, 16 experts
    ("random", 2, 9, 8, 64, 8),        # olmoe's widths
])
def test_dispatch_indices_match_the_reference(kind, b, s, k, e, cap):
    top_e = _top_e(kind, b, s, k, e, seed=s)
    js, jk = jax.vmap(lambda t: JM.dispatch_indices(t, k, e, cap))(
        jnp.asarray(top_e))
    ps, pk = PM.dispatch_indices(torch.from_numpy(top_e).long(), k, e, cap)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    counts = np.bincount(top_e.reshape(b, -1)[0], minlength=e)
    assert int((~pk[0]).sum()) == int(np.maximum(counts - cap, 0).sum())
    # kept entries take distinct slots inside their expert's range
    for row in range(b):
        kept = ps[row][pk[row]].numpy()
        assert len(set(kept)) == len(kept)
        flat = top_e.reshape(b, -1)[row][pk[row].numpy()]
        assert ((kept // cap) == flat).all()


@pytest.mark.parametrize("case", ["default", "drops"])
def test_moe_mlp_matches_the_reference(pair, case):
    """The layer's output, `expert_tokens` (counts before the drop) and
    `dropped_tokens`; with `drops` a low capacity factor and a skewed
    router make experts overflow, and the slots and keep masks of the
    routing are held equal too."""
    jcfg, _, jp, pcfg, _, pp = pair
    jmoe, pmoe = _layer0(jp, pp)
    x = _x(pcfg, 2, 16, seed=1)
    if case == "drops":
        jcfg, pcfg, jmoe, pmoe = _skewed(jcfg, pcfg, jmoe, pmoe)
        x = x + SHIFT
    jy, ja = JM.moe_mlp(jmoe, jcfg, jnp.asarray(x))
    py, pa = PM.moe_mlp(pmoe, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(to_np(py), to_np(jy), **TOL)
    assert set(pa) == set(ja)
    np.testing.assert_array_equal(pa["expert_tokens"].numpy(),
                                  np.asarray(ja["expert_tokens"]))
    assert pa["expert_tokens"].dtype == torch.int32
    assert int(pa["expert_tokens"].sum()) == 2 * 16 * pcfg.moe.top_k
    assert int(pa["dropped_tokens"]) == int(ja["dropped_tokens"])
    for key in ("router_aux_loss", "router_logits_max"):
        np.testing.assert_allclose(to_np(pa[key]), to_np(ja[key]), **TOL)
    if case == "drops":
        assert int(pa["dropped_tokens"]) > 0
        cap = PM.capacity(16, pcfg.moe)
        je, _, _ = JM.route(jmoe["router"], jnp.asarray(x), jcfg.moe)
        pe, _, _ = PM.route(pmoe["router"], torch.from_numpy(x), pcfg.moe)
        k, e = pcfg.moe.top_k, pcfg.moe.n_experts
        js, jk = jax.vmap(lambda t: JM.dispatch_indices(t, k, e, cap))(je)
        ps, pk = PM.dispatch_indices(pe, k, e, cap)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


def test_moe_specs_match_the_reference(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    want = jax.tree.map(lambda s: tuple(s.shape), JM.moe_specs(jcfg),
                        is_leaf=lambda s: hasattr(s, "axes"))
    got = L.map_specs(lambda s: tuple(s.shape), PM.moe_specs(pcfg))
    assert got == want
    assert ("shared" in got) == bool(pcfg.moe.n_shared_experts)
    fresh = pm.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        jax.tree.map(lambda a: tuple(a.shape), fresh)
    assert pm.param_count(fresh) == jm.param_count(jp)


def test_full_width_olmoe_builds_without_allocating():
    """The published widths: the model builds, its parameter count is the
    config's (6.92 B), and its block table traces on meta tensors."""
    cfg = get_config("olmoe-1b-7b")
    model = build_model(cfg, device="cpu")
    assert model.param_count() == cfg.param_count() == \
        jbuild(jget("olmoe-1b-7b")).param_count()
    assert 6.9e9 < cfg.param_count() < 7.0e9
    tab = PB.build_block_table(model, ShapeConfig("p", "prefill", 256, 1),
                               train=False, unit="flops")
    moe = tab.blocks[tab.id_of("moe")]
    # three expert products over 64 experts' buffers of capacity 40
    assert moe.cost_flops >= 3 * 2 * 64 * 40 * 2048 * 1024


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_lm_forward_logits_and_aux(pair):
    jcfg, jm, jp, pcfg, pm, pp = pair
    toks = _tokens(pcfg, 2, 24)
    want, ja = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, pa = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    assert set(pa) == set(ja)
    np.testing.assert_array_equal(pa["expert_tokens"].numpy(),
                                  np.asarray(ja["expert_tokens"]))
    assert int(pa["expert_tokens"].sum()) == \
        2 * 24 * pcfg.moe.top_k * pcfg.n_layers
    assert int(pa["dropped_tokens"]) == int(ja["dropped_tokens"])
    for key in ("router_aux_loss", "router_logits_max"):
        np.testing.assert_allclose(to_np(pa[key]), to_np(ja[key]), **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def grads(request):
    """Loss, aux and gradients of both packages (JAX: the chunked
    attention, its training default; port: `_train_cfg`, remat "full") on
    one converted parameter tree and one batch."""
    arch = request.param
    jcfg = jreduced(jget(arch))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = _train_cfg(reduced(get_config(arch)))
    pm = build_model(pcfg, device="cpu")
    from repro_torch.convert import params_from_numpy
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    jb, pb = _batch(jcfg, 0)
    (jl, ja), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jp)
    leaves = L.tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    pl, pa = pm.loss(pp, pb)
    pg = torch.autograd.grad(pl, leaves)
    return (jm, jp, jl, ja, jg), (pm, pp, pl, pa, pg)


def test_loss_matches_with_the_router_term(grads):
    (jm, jp, jl, ja, _), (pm, pp, pl, pa, _) = grads
    assert abs(pl.item() - float(jl)) <= 2e-4 * max(1.0, abs(float(jl)))
    np.testing.assert_allclose(pa["router_aux_loss"].item(),
                               float(ja["router_aux_loss"]), **TOL)
    assert pa["router_aux_loss"].item() > 0
    # the router term is in the loss: the loss less the CE's
    from repro_torch.models.model_zoo import cross_entropy
    from repro_torch.models.transformer import lm_forward
    with torch.no_grad():
        logits, _ = lm_forward(pp, pm.cfg, pm.dims, _batch(pm.cfg, 0)[1]["tokens"])
        ce = cross_entropy(logits, _batch(pm.cfg, 0)[1]["labels"],
                           pm.cfg.vocab_size)[0]
    want = pa["router_aux_loss"].item() / pm.cfg.n_layers
    assert abs(pl.item() - ce.item() - want) <= 1e-6 * max(1.0, want) + 1e-7


def test_gradients_match_the_jax_package(grads):
    (jm, jp, jl, ja, jg), (pm, pp, pl, pa, pg) = grads
    want = _flat(jax.tree.map(np.asarray, jg))
    got = dict(zip(_flat(pp), pg))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= 2e-4, k
    # the router's gradient comes from the gates and from the aux loss
    router = L.tree_leaves(pp["layers"]["moe"]["router"])[0]
    idx = [i for i, t in enumerate(L.tree_leaves(pp)) if t is router][0]
    assert pg[idx].abs().max().item() > 0


def test_aux_under_remat_counts_once_and_keeps_its_grad():
    """Rematerialised layers (by layer, by groups of 2) give the aux of a
    forward without remat: the integer counts do not double when the
    checkpointed body is recomputed in the backward, the router loss keeps
    its `grad_fn`, and the gradients are the same."""
    base = _train_cfg(reduced(get_config("olmoe-1b-7b"), n_layers=4))
    params = build_model(base, device="cpu").init(
        torch.Generator().manual_seed(0))
    leaves = L.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    _, batch = _batch(base, 0, 16, 2)
    with torch.no_grad():
        _, want = build_model(base, device="cpu").loss(params, batch)
    out = []
    for kw in ({}, {"remat_group": 2}, {"remat": "none"}):
        m = build_model(dataclasses.replace(base, **kw), device="cpu")
        loss, aux = m.loss(params, batch)
        assert aux["router_aux_loss"].grad_fn is not None
        g = torch.autograd.grad(loss, leaves)
        for key in ("expert_tokens", "dropped_tokens"):
            assert torch.equal(aux[key], want[key]), (kw, key)
        assert int(aux["expert_tokens"].sum()) == 2 * 16 * 2 * 4
        out.append((loss, g))
    for loss, g in out[1:]:
        assert loss.item() == pytest.approx(out[0][0].item(), abs=1e-6)
        for a, b in zip(g, out[0][1]):
            assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_prefill_and_decode_match_the_forward(pair):
    """The port's twin of `tests/test_models.py::
    test_prefill_decode_matches_forward`: capacity depends on the sequence,
    so the capacity factor is raised to 8 (no token drops in either), and
    prefill + decode steps give the full forward's logits.  The decode
    steps' logits and router statistics are also the JAX package's."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    pcfg8 = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=8.0))
    jcfg8 = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0))
    pm, jm = build_model(pcfg8, device="cpu"), jbuild(jcfg8)
    b, s, p = 2, 16, 8
    toks = _tokens(pcfg, b, s, seed=3)
    full, faux = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    assert int(faux["dropped_tokens"]) == 0
    cache = pm.init_cache(b, s + 4)
    jc = jm.init_cache(b, s + 4)
    lg, cache, aux = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :p])},
                                cache)
    jl, jc, jaux = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :p])}, jc)
    np.testing.assert_allclose(to_np(lg), to_np(jl), **TOL)
    assert int(aux["expert_tokens"].sum()) == b * p * pcfg.moe.top_k * \
        pcfg.n_layers
    errs = [np.abs(to_np(lg[:, 0]) - to_np(full[:, p - 1])).max()]
    for t in range(p, s):
        tok = toks[:, t:t + 1]
        lg, cache, aux = pm.decode_step(pp, torch.from_numpy(tok), cache)
        jl, jc, jaux = jm.decode_step(jp, jnp.asarray(tok), jc)
        np.testing.assert_allclose(to_np(lg), to_np(jl), **TOL)
        np.testing.assert_array_equal(aux["expert_tokens"].numpy(),
                                      np.asarray(jaux["expert_tokens"]))
        assert int(aux["expert_tokens"].sum()) == \
            b * pcfg.moe.top_k * pcfg.n_layers
        assert int(aux["dropped_tokens"]) == int(jaux["dropped_tokens"]) == 0
        errs.append(np.abs(to_np(lg[:, 0]) - to_np(full[:, t])).max())
    assert max(errs) < 2e-4, errs


def test_prefill_drops_as_the_reference_does(pair):
    """At the configs' own capacity factor a prefill of 24 tokens overflows
    some experts (a decode step, of capacity 8 for one token a row, never
    does); the port drops the same tokens as the JAX package, so its
    logits and router statistics are still the JAX package's."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    toks = _tokens(pcfg, 2, 24)
    jl, _, ja = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(2, 32))
    pl, _, pa = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                           pm.init_cache(2, 32))
    assert int(pa["dropped_tokens"]) == int(ja["dropped_tokens"]) > 0
    np.testing.assert_array_equal(pa["expert_tokens"].numpy(),
                                  np.asarray(ja["expert_tokens"]))
    np.testing.assert_allclose(to_np(pl), to_np(jl), **TOL)


def test_engine_matches_the_jax_engine(pair):
    """Greedy serving: the same tokens, request by request, as the JAX
    engine (prompts padded with token 0 to the prefill length, as both
    engines do; padding takes capacity like any token)."""
    jcfg, jm, jp, pcfg, pm, pp = pair
    kw = dict(batch=3, max_seq=48, prefill_len=12, instrument=False)
    jeng = JEngine(jcfg, **kw)
    peng = ServeEngine(pcfg, device="cpu", **kw)
    jgen = JRequests(jcfg.vocab_size, prompt_len=9, mean_new=8, seed=0)
    pgen = SyntheticRequests(pcfg.vocab_size, prompt_len=9, mean_new=8, seed=0)
    jstats = jeng.run(jp, [jgen.request(i) for i in range(6)])
    pstats = peng.run(pp, [pgen.request(i) for i in range(6)])
    assert {r.req_id: tuple(r.output) for r in peng.done} == \
        {r.req_id: tuple(r.output) for r in jeng.done}
    assert pstats["iterations"] == jstats["iterations"]
    assert peng.kinds_log == jeng.kinds_log


def test_engine_profile_has_the_virtual_blocks(pair):
    *_, pcfg, pm, pp = pair
    eng = ServeEngine(pcfg, batch=2, max_seq=32, prefill_len=8, device="cpu")
    gen = SyntheticRequests(pcfg.vocab_size, prompt_len=8, mean_new=4, seed=0)
    eng.run(pp, [gen.request(i) for i in range(3)])
    prof = eng.profile()
    names = prof.table.names
    for kind in ("prefill", "decode"):
        for block in ("attn", "moe", "dropped_tokens"):
            assert f"{kind}/{block}" in names
    assert prof.n_intervals >= 1


# ---------------------------------------------------------------------------
# the block table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,seq,batch", [("prefill", 16, 1),
                                            ("decode", 64, 3),
                                            ("train", 16, 2)])
def test_block_table_matches_the_reference(arch, kind, seq, batch):
    """Block names (the virtual `expert_tok_*` and `dropped_tokens` after
    `head`, with their aux keys), the step program and the matrix-product
    FLOPs of every block.  The reference's moe block is `moe_mlp` alone,
    without its norm and residual; so is the port's."""
    jcfg = dataclasses.replace(jreduced(jget(arch)),
                               attention_impl="reference")
    jmodel = jbuild(jcfg)
    pmodel = build_model(reduced(get_config(arch)), device="cpu")
    jtab = JB.build_block_table(jmodel, JShape("x", kind, seq, batch),
                                train=False, unit="flops")
    pshape = ShapeConfig("x", kind, seq, batch)
    ptab = PB.build_block_table(pmodel, pshape, train=False, unit="flops")
    e = pmodel.cfg.moe.n_experts
    assert ptab.names == jtab.names == ["embed", "attn", "moe", "head"] + \
        [f"expert_tok_{i}" for i in range(e)] + ["dropped_tokens"]
    assert [dataclasses.asdict(s) for s in ptab.program] == \
        [dataclasses.asdict(s) for s in jtab.program]
    for a, b in zip(ptab.blocks, jtab.blocks):
        assert (a.virtual, a.dyn_key, a.dyn_index) == \
            (b.virtual, b.dyn_key, b.dyn_index), a.name
    assert ptab.virtual_ids() == jtab.virtual_ids()
    np.testing.assert_array_equal(ptab.step_counts(), jtab.step_counts())

    dt = jnp.float32
    s = seq if kind != "decode" else 1
    x = jax.ShapeDtypeStruct((batch, s, jcfg.d_model), dt)
    lp = JB._spec_struct(JT.layer_specs(jcfg, jmodel.dims), dt)
    jmoe = jax.make_jaxpr(lambda p, xx: JM.moe_mlp(p["moe"], jcfg, xx)[0])(
        lp, x)
    graphs = {name: trace_graph(fn, *args)
              for name, fn, args in PB.block_functions(pmodel, pshape)}
    assert matmul_flops(graphs["moe"]) == _jax_dot_flops(jmoe)
    assert matmul_flops(graphs["moe"]) > 0


def test_train_table_scale_is_traced_for_moe():
    cfg = _train_cfg(get_config("olmoe-1b-7b"))
    scale = PB.train_scale_traced(cfg)
    assert scale > 1.0 and scale != 3.0
    assert scale * 1024 == int(scale * 1024)


# ---------------------------------------------------------------------------
# the router's jitter
# ---------------------------------------------------------------------------


def test_jitter_is_deterministic_per_seed_and_step_and_moves_the_logits():
    """Threefry values cannot be matched, so the parity tests run with
    jitter 0; with jitter > 0 the router's noise comes from a generator
    seeded from (the state's key, the step): the same pair gives the same
    routing and loss, another step other ones, and no generator none."""
    cfg = _train_cfg(reduced(get_config("olmoe-1b-7b")))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.5))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(cfg, 2, 8))
    router = L.tree_index(params["layers"]["moe"], 0)["router"]
    key = np.asarray([0, 7], np.uint32)

    def logits_max(step):
        gen = None if step is None else step_generator(key, step, "cpu")
        return PM.route(router, x, cfg.moe, gen)[2]["router_logits_max"]
    plain = logits_max(None)
    assert torch.equal(logits_max(3), logits_max(3))
    assert not torch.equal(logits_max(3), logits_max(4))
    assert not torch.equal(logits_max(3), plain)
    # a jitter of 0 draws nothing, whatever the generator
    cfg0 = dataclasses.replace(cfg.moe, router_jitter=0.0)
    assert torch.equal(PM.route(router, x, cfg0, step_generator(key, 3, "cpu")
                                )[2]["router_logits_max"], plain)

    _, batch = _batch(cfg, 0, 16, 2)
    losses = {}
    for step in (3, 3, 4):
        gen = step_generator(key, step, "cpu")
        with torch.no_grad():
            losses.setdefault(step, []).append(
                model.loss(params, batch, rng=gen)[0].item())
    assert losses[3][0] == losses[3][1] != losses[4][0]
    # remat recomputes each layer with the jitter it drew the first time
    leaves = L.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    g = {}
    for remat in ("full", "none"):
        m = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        loss = m.loss(params, batch, rng=step_generator(key, 3, "cpu"))[0]
        g[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(g["full"], g["none"]):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_train_step_with_jitter_is_reproducible():
    cfg = _train_cfg(reduced(get_config("olmoe-1b-7b")))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.5))
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, seq_len=16, batch=2, device="cpu", instrument=False)
        tr.run(2)
        runs.append([r["loss"] for r in tr.metrics_history])
    assert runs[0] == runs[1]
    tr0 = Trainer(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.0)), seq_len=16, batch=2, device="cpu",
        instrument=False)
    tr0.run(2)
    assert [r["loss"] for r in tr0.metrics_history] != runs[0]


# ---------------------------------------------------------------------------
# the port's twin of tests/test_system.py's MoE checks
# ---------------------------------------------------------------------------


N_STEPS = 30


@pytest.fixture(scope="module")
def trained():
    cfg = _train_cfg(reduced(get_config("olmoe-1b-7b")))
    tr = Trainer(cfg, seq_len=32, batch=4, interval_steps=2.5, seed=0,
                 device="cpu")
    state = tr.run(N_STEPS)
    return tr, state


def test_moe_phases_visible_in_bbvs(trained):
    """The phased corpus shifts expert routing; interval BBVs must reflect
    it (the data-dependent signature entries carry real signal)."""
    tr, _ = trained
    prof = tr.profile()
    x = prof.bbv_matrix()
    virt = prof.table.virtual_ids()
    v = x[:, virt[:-1]]                        # expert_tok_* columns
    assert (v.sum(0) > 0).all()
    v = v / np.maximum(v.sum(1, keepdims=True), 1)
    spread = v.max(0) - v.min(0)
    assert spread.max() > 0.02                 # routing mix moves over phases


def test_meter_matches_host_builder(trained):
    """The device meter agrees with the host-side stream: the static
    blocks' counts are the table's, and the virtual ones hold the router
    statistics the step returned."""
    from repro_torch.core.meter import read_meter
    tr, _ = trained
    state = tr.init_state()
    state, _, aux = tr._step_fn(state, tr._device_batch(0))
    m = read_meter(state.meter)
    assert m["steps"] == 1
    table = tr.table
    want = table.step_counts()
    nv = [i for i, b in enumerate(table.blocks) if not b.virtual]
    np.testing.assert_array_equal(m["counts"][nv], want[nv])
    assert int(m["uow"]) == int(round(table.step_uow()))
    virt = table.virtual_ids()
    np.testing.assert_array_equal(m["counts"][virt[:-1]],
                                  aux["expert_tokens"].numpy())
    assert m["counts"][virt[-1]] == int(aux["dropped_tokens"])
    assert int(aux["expert_tokens"].sum()) == 4 * 32 * 2 * 2


def test_run_meter_holds_every_steps_router_statistics(trained):
    """Over the whole run: meter = steps x the table's counts for the static
    blocks plus the summed dynamic entries, which the deferred builder's log
    holds as host arrays after the run's drain (`materialize_dyn`)."""
    tr, state = trained
    reading = tr.meter_reading
    assert reading["steps"] == N_STEPS
    log = tr.builder.step_log
    assert len(log) == N_STEPS
    for _, dyn in log:
        assert isinstance(dyn["expert_tokens"], np.ndarray)
        assert dyn["expert_tokens"].dtype == np.int32
    tokens = sum(dyn["expert_tokens"] for _, dyn in log)
    dropped = sum(int(dyn["dropped_tokens"]) for _, dyn in log)
    table = tr.table
    virt = table.virtual_ids()
    want = N_STEPS * table.step_counts()
    want[virt[:-1]] += tokens
    want[virt[-1]] += dropped
    np.testing.assert_array_equal(reading["counts"], want)
    assert tokens.sum() == N_STEPS * 4 * 32 * 2 * 2


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_the_moe_family_on_the_cpu(arch, capsys):
    """`--arch olmoe-1b-7b` and `--arch llama4-scout-17b-a16e` (reduced,
    `--device cpu`) through the serve and train launchers."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    stats = serve_cli.main(["--arch", arch, "--reduced", "--requests", "2",
                            "--batch", "2", "--max-seq", "32",
                            "--prefill-len", "8", "--device", "cpu"])
    assert stats["requests"] == 2
    out = train_cli.main(["--arch", arch, "--reduced", "--steps", "2",
                          "--seq-len", "16", "--batch", "2",
                          "--device", "cpu"])
    assert np.isfinite(out["final_loss"])
    capsys.readouterr()
