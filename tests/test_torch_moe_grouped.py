"""The MoE decode step's grouped path (`models/moe.py` `grouped_route`,
`kernels/moe_grouped.py`) on the CPU, in f32 at the reduced size.

The kernel runs only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`);
here its plain version, a loop over the experts on the entries sorted by
expert, is held against the buffer path at one token a row: reduced
olmoe-1b-7b and reduced llama4-scout-17b-a16e (a shared expert), top-k of 1, 2
and 8, 1, 3 and 64 rows, and routes from the router, skewed, and every token
to the same experts.  Then the sort, counts and ends against
`dispatch_indices`, the most rows the m16 tiles can cover against every
route, which inputs the route sends to the buffer path (CPU, meta, fake
tensors under a trace, DTensors, ``s > 1``), and the registry's counters.
The grouped path is also held against the JAX package's `moe_mlp` at one
token a row, on the same parameters and routes."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_port import run_ranks, to_np
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import moe as JM
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.core.unit_of_work import trace_graph
from repro_torch.kernels import build
from repro_torch.kernels import moe_grouped as G
from repro_torch.models import layers as L
from repro_torch.models import moe as PM
from repro_torch.models.model_zoo import build_model

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
# the buffer path and the plain grouped version multiply the same f32 rows in
# another blocking: the tolerance of tests/test_torch_moe.py (the reference's
# own cross-implementation tolerance)
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg(arch, k, jax=False):
    cfg = jreduced(jget(arch)) if jax else reduced(get_config(arch))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=k, n_experts=max(cfg.moe.n_experts, 2 * k)))


_PARAMS = {}


def _moe_params(cfg):
    """Layer 0's MoE parameters of the reduced model, drawn once per
    configuration."""
    key = (cfg.name, cfg.moe.n_experts, cfg.moe.top_k)
    if key not in _PARAMS:
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        _PARAMS[key] = L.tree_index(params["layers"]["moe"], 0)
    return _PARAMS[key]


def _x(cfg, b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 1, cfg.d_model)).astype(np.float32))


def _forced_route(kind, b, k, e, seed=0):
    """(expert ids [B, 1, k], gates [B, 1, k]) of a route of ``kind``:
    ``same`` sends every token to experts 0..k-1, ``skewed`` half the tokens'
    first choice to expert 0 and the rest at random (k distinct experts a
    token, as top-k gives)."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(e)[:k] for _ in range(b)])
    if kind == "same":
        ids = np.tile(np.arange(k), (b, 1))
    elif kind == "skewed":
        for row in range(0, b, 2):
            if 0 not in ids[row]:
                ids[row, 0] = 0
    g = rng.random((b, k)).astype(np.float32) + 0.1
    g /= g.sum(-1, keepdims=True)
    return (torch.from_numpy(ids.astype(np.int64))[:, None],
            torch.from_numpy(g)[:, None])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("kind", ["router", "skewed", "same"])
def test_grouped_plain_version_equals_the_buffer_path(arch, k, b, kind,
                                                      monkeypatch):
    cfg = _cfg(arch, k)
    params = _moe_params(cfg)
    x = _x(cfg, b, seed=k + b)
    top_e, top_g, aux = PM.route(params["router"], x, cfg.moe)
    if kind != "router":
        top_e, top_g = _forced_route(kind, b, k, cfg.moe.n_experts, seed=b)
    monkeypatch.setattr(PM, "route", lambda *a, **kw: (top_e, top_g,
                                                       dict(aux)))
    want, want_aux = PM.moe_mlp(params, cfg, x)           # the buffer path
    got, got_aux = PM._grouped_moe(params, cfg, x, top_e, top_g, dict(aux))
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got_aux["expert_tokens"], want_aux["expert_tokens"])
    assert int(want_aux["dropped_tokens"]) == 0
    assert int(got_aux["dropped_tokens"]) == 0
    assert set(got_aux) == set(want_aux)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("kind", ["router", "skewed", "same"])
def test_grouped_path_matches_the_jax_package(arch, k, b, kind, monkeypatch):
    """The grouped path at [B, 1, d] against the JAX package's `moe_mlp` on
    the same parameters: the output, `expert_tokens`, `dropped_tokens` and
    the router's aux entries.  A forced route replaces both packages'
    top-k choice; the aux loss and the logits' maximum stay the router's."""
    cfg, jcfg = _cfg(arch, k), _cfg(arch, k, jax=True)
    params = _moe_params(cfg)
    jparams = _to_jax(params)
    x = _x(cfg, b, seed=3 * k + b)
    top_e, top_g, aux = PM.route(params["router"], x, cfg.moe)
    if kind != "router":
        top_e, top_g = _forced_route(kind, b, k, cfg.moe.n_experts, seed=k)
        real = JM.route

        def forced(*a, **kw):
            return (jnp.asarray(top_e.numpy().astype(np.int32)),
                    jnp.asarray(top_g.numpy()), real(*a, **kw)[2])
        monkeypatch.setattr(JM, "route", forced)
    jy, ja = JM.moe_mlp(jparams, jcfg, jnp.asarray(x.numpy()))
    got, got_aux = PM._grouped_moe(params, cfg, x, top_e, top_g, dict(aux))
    np.testing.assert_allclose(to_np(got), to_np(jy), **TOL)
    assert set(got_aux) == set(ja)
    np.testing.assert_array_equal(got_aux["expert_tokens"].numpy(),
                                  np.asarray(ja["expert_tokens"]))
    assert int(got_aux["dropped_tokens"]) == int(ja["dropped_tokens"]) == 0
    for key in ("router_aux_loss", "router_logits_max"):
        np.testing.assert_allclose(to_np(got_aux[key]), to_np(ja[key]), **TOL)


@pytest.mark.parametrize("kind", ["router", "skewed", "same"])
@pytest.mark.parametrize("b,k,e", [(1, 1, 4), (3, 2, 4), (64, 8, 64),
                                   (256, 8, 64), (8, 1, 16)])
def test_sort_counts_and_ends_agree_with_dispatch_indices(kind, b, k, e):
    m = dataclasses.replace(get_config("olmoe-1b-7b").moe, n_experts=e,
                            top_k=k)
    if kind == "router":
        logits = torch.from_numpy(np.random.default_rng(b).standard_normal(
            (b, 1, e)).astype(np.float32))
        top_e = torch.topk(logits, k, dim=-1).indices
    else:
        top_e, _ = _forced_route(kind, b, k, e, seed=e)
    cap = PM.capacity(1, m)
    slot, keep = PM.dispatch_indices(top_e, k, e, cap)
    assert bool(keep.all())                    # at decode nothing drops
    flat = top_e.reshape(-1)
    counts = PM.expert_counts(flat, e)
    order, ends = G.sort_entries(flat, counts)
    assert order.dtype == torch.int64 and ends.dtype == torch.int32
    assert torch.equal(counts, torch.bincount(flat, minlength=e).int())
    assert torch.equal(ends - counts, torch.cumsum(counts, 0) - counts)
    assert int(ends[-1]) == b * k
    expert_of_slot = (slot.reshape(-1) // cap)        # the buffer path's
    for ex in range(e):
        part = order[int(ends[ex] - counts[ex]):int(ends[ex])]
        # expert ex's entries, in (token, k) order: the stable sort
        want = torch.nonzero(expert_of_slot == ex).reshape(-1)
        assert torch.equal(part, want), ex
    # the m16 tiles this route fills lie within the count from shapes
    tiles = int(((counts + G.ROW_TILE - 1) // G.ROW_TILE).sum())
    assert b * k <= tiles * G.ROW_TILE <= G.grouped_rows(b * k, e)


def _most_rows(n, e, tile):
    """Brute force: the most rows of `tile`-row tiles that any split of n
    entries over e experts fills."""
    best = 0
    for cuts in itertools.combinations_with_replacement(range(n + 1), e - 1):
        parts = np.diff((0,) + cuts + (n,))
        best = max(best, int(sum(-(-p // tile) for p in parts)) * tile)
    return best


@pytest.mark.parametrize("n,e", [(1, 1), (1, 4), (5, 3), (16, 2), (17, 2),
                                 (33, 3), (40, 4), (64, 1)])
def test_grouped_rows_is_the_most_any_route_fills(n, e):
    assert G.grouped_rows(n, e) == _most_rows(n, e, G.ROW_TILE)


def test_grouped_rows_at_the_benchmark_shapes():
    # chat: 256 rows x top-8 over 64 experts; long prompt: 96 rows; llama4:
    # 8 rows x top-1 over 16 experts
    assert G.grouped_rows(2048, 64) == 16 * (2048 + 15 * 64) // 16 == 3008
    assert G.grouped_rows(768, 64) == 1728
    assert G.grouped_rows(8, 16) == 16 * ((8 + 15 * 8) // 16) == 128


def _fake_cuda(shape, dtype=torch.bfloat16):
    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype, device="cuda")


def test_the_route_takes_the_grouped_path_only_where_the_kernel_serves():
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=1)
    d, fe = cfg.d_model, cfg.moe.d_expert
    params = {"wi": _fake_cuda((cfg.moe.n_experts, d, fe))}
    # a plain bf16 CUDA tensor of one token a row, outside any trace
    assert PM.grouped_route(cfg, _fake_cuda((256, 1, d)), params)
    # the prefill and training: capacity and drops
    assert not PM.grouped_route(cfg, _fake_cuda((2, 16, d)), params)
    # elsewhere than the card
    assert not PM.grouped_route(cfg, torch.zeros((4, 1, d),
                                                 dtype=torch.bfloat16), params)
    assert not PM.grouped_route(
        cfg, torch.empty((4, 1, d), dtype=torch.bfloat16, device="meta"),
        params)
    # what the kernel does not compute
    assert not PM.grouped_route(cfg, _fake_cuda((4, 1, d), torch.float32),
                                params)
    for change in (dict(glu=False), dict(act="gelu")):
        assert not PM.grouped_route(dataclasses.replace(cfg, **change),
                                    _fake_cuda((4, 1, d)), params)
    assert not PM.grouped_route(
        dataclasses.replace(cfg, d_model=d + 8), _fake_cuda((4, 1, d + 8)),
        params)
    # under a trace or a fake-tensor mode (the block tables, the dry-run)
    with FakeTensorMode(allow_non_fake_inputs=True):
        assert not PM.grouped_route(cfg, _fake_cuda((4, 1, d)), params)
    # a gradient to carry
    x = _fake_cuda((4, 1, d)).requires_grad_()
    assert not PM.grouped_route(cfg, x, params)
    with torch.no_grad():
        assert PM.grouped_route(cfg, x, params)


def test_meta_and_traced_decode_steps_take_the_buffer_path():
    cfg = _cfg("olmoe-1b-7b", 2)
    params = _moe_params(cfg)
    x = _x(cfg, 3)
    m = cfg.moe
    reg = obs.metrics()
    before = {n: reg.value(n) or 0 for n in ("moe.slots",
                                             "moe.grouped_entries")}
    y, aux = PM.moe_mlp(params, cfg, x)          # CPU: the buffer path
    assert (reg.value("moe.slots") or 0) - before["moe.slots"] == \
        3 * m.n_experts * PM.capacity(1, m)
    meta = {k: v.to("meta") for k, v in params.items() if k != "router"}
    meta["router"] = {"kernel": params["router"]["kernel"].to("meta")}
    ym, _ = PM.moe_mlp(meta, cfg, x.to("meta"))
    assert ym.shape == y.shape and ym.device.type == "meta"
    # the block tables' trace: the buffer's scatter is in the graph
    gm = trace_graph(lambda p, xx: PM.moe_mlp(p, cfg, xx)[0], params, x)
    assert any(n.target in (torch.ops.aten.index_add_.default,
                            torch.ops.aten.index_add.default)
               for n in gm.graph.nodes)
    assert (reg.value("moe.grouped_entries") or 0) == \
        before["moe.grouped_entries"]


def _dtensor_route(rank, world, init_file):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = _cfg("olmoe-1b-7b", 2)
    params = _moe_params(cfg)
    x = _x(cfg, 3)
    def rep(t):
        return DTensor.from_local(t, mesh, [Replicate()] * 2, run_check=False)
    xd = rep(x)
    pd = {k: rep(v) for k, v in params.items() if k != "router"}
    pd["router"] = {"kernel": rep(params["router"]["kernel"])}
    route = PM.grouped_route(cfg, xd, pd)
    y, _ = PM.moe_mlp(pd, cfg, xd)
    want, _ = PM.moe_mlp(params, cfg, x)
    y = y.full_tensor() if isinstance(y, DTensor) else y
    return route, float((y - want).abs().max())


def test_a_dtensor_takes_the_buffer_path():
    ((route, err),) = run_ranks(_dtensor_route, 1, timeout=180)
    assert route is False
    assert err <= 1e-5


@pytest.mark.parametrize("arch,k,b", [("olmoe-1b-7b", 8, 64),
                                      ("llama4-scout-17b-a16e", 1, 3)])
def test_grouped_counters_are_the_shape_arithmetic(arch, k, b):
    cfg = _cfg(arch, k)
    params = _moe_params(cfg)
    x = _x(cfg, b)
    top_e, top_g, aux = PM.route(params["router"], x, cfg.moe)
    names = ("moe.entries", "moe.slots", "moe.grouped_entries")
    reg = obs.metrics()
    before = {n: reg.value(n) or 0 for n in names}
    launches = build.launches()
    PM._grouped_moe(params, cfg, x, top_e, top_g, aux)
    got = {n: (reg.value(n) or 0) - before[n] for n in names}
    n = b * k
    assert got == {"moe.entries": n,
                   "moe.slots": G.grouped_rows(n, cfg.moe.n_experts),
                   "moe.grouped_entries": n}
    assert got["moe.slots"] > 0
    assert build.launches() == launches       # the CPU takes no kernel


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    cfg = _cfg("olmoe-1b-7b", 2)
    p = _moe_params(cfg)
    x = _x(cfg, 5)[:, 0]
    top_e, _ = _forced_route("skewed", 5, 2, cfg.moe.n_experts)
    flat = top_e.reshape(-1)
    counts = PM.expert_counts(flat, cfg.moe.n_experts)
    order, ends = G.sort_entries(flat, counts)
    args = (x, p["wi"], p["wg"], p["wo"], order, counts, ends)
    torch.testing.assert_close(G.grouped_mlp(*args, top_k=2),
                               G.grouped_mlp_plain(*args, top_k=2),
                               rtol=0, atol=0)
