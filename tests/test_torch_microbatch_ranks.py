"""The port's train step with `microbatch` > 1 on a sharded state (ROADMAP
Queue C 4): f32 accumulators that keep each leaf's placements, and a batch
split that keeps every rank's own rows.

- On 4 gloo ranks (a (data 2, model 2) mesh), reduced qwen3-1.7b on the
  chunked impls, batch 8 x 16: the sharded `microbatch=2` step against the
  single-rank `microbatch=1` step from the same parameters, in loss and
  every updated parameter within 1e-5 relative (of the leaf's largest
  value; the two sum in other orders).  The plain pair (`microbatch` 2
  against 1 on one rank) agrees within 4.8e-7 (absolute: f32 sums of two
  halves against one whole; 4 ulp of the loss).  As in
  tests/test_torch_distributed_ranks.py, parameters are held so outside
  Adam's eps elements (first moment below 1e-7, where rounding sets the
  step): there within 2·lr.
- The input that showed the fault: a one-rank (data 1, model 1) gloo mesh,
  batch 4 x 16, `microbatch=2` (it raised `aten.add_.Tensor got mixed
  torch.Tensor and DTensor`).
- The per-rank program of the sharded `microbatch=2` step, recorded on fake
  tensors as rank 0 of a fake group of 4, gathers no batch rows: no
  collective has an integer operand (tokens and labels are the step's only
  integer tensors).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_distributed import one_rank_group  # noqa: F401

LR = 1e-3
REL_TOL = 1e-5
PLAIN_TOL = 4.8e-7
ADAM_FLOOR = 1e-7


def _cfg():
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               attention_impl="chunked", ssm_impl="chunked")


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).int()
    return {"tokens": toks, "labels": toks.roll(-1, dims=1)}


def _step(cfg, p0, batch, microbatch, mesh=None):
    """(loss, updated parameters, first moments) of one step from ``p0``,
    as plain numpy arrays, on ``mesh`` under the training plan if given."""
    from repro_torch.distributed.sharding import (distribute,
                                                  distribute_batch,
                                                  logical_rules,
                                                  params_shardings, to_plain,
                                                  use_rules)
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.state import init_train_state, make_train_step
    plan = logical_rules(mesh, mode="train") if mesh is not None else None
    with use_rules(plan):
        model = build_model(cfg, plan, device="cpu")
        params = tree_map(lambda t: t.clone(), p0)
        if mesh is not None:
            params = distribute(params, params_shardings(mesh, plan,
                                                         model.axes()))
            batch = distribute_batch(batch, plan)
        opt = AdamWConfig(lr=LR)
        state = init_train_state(model, params, opt)
        step = make_train_step(model, opt, constant(LR),
                               microbatch=microbatch, instrument=False)
        state, met, _ = step(state, batch)
        return float(met["loss"]), [
            [to_plain(p).detach().numpy() for p in tree_leaves(tree)]
            for tree in (state.params, state.opt.mu)]


def _rank(rank, world, init_file):
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.model_zoo import build_model
    init_process_group(init_file, rank, world, device="cpu", timeout_s=120)
    mesh = make_host_mesh(model=2, device="cpu")
    cfg = _cfg()
    batch = _batch(cfg, 8, 16)
    p0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    out = {"mesh": tuple(mesh.shape)}
    for name, mb, m in (("plain1", 1, None), ("plain2", 2, None),
                        ("sharded2", 2, mesh)):
        loss, params = _step(cfg, p0, batch, mb, m)
        out[name] = (loss, params if rank == 0 else None)
    return out


@pytest.fixture(scope="module")
def four_ranks():
    from _torch_port import run_ranks
    return run_ranks(_rank, 4, timeout=240)


def _params_within(got, want, tol):
    """Every updated parameter of ``got`` within ``tol`` of ``want``'s
    leaf's largest value (at least 1) outside Adam's eps elements of
    ``want``, and within 2·lr inside them."""
    (p_got, _), (p_want, mu) = got, want
    for g, w, m in zip(p_got, p_want, mu):
        d, tiny = np.abs(g - w), np.abs(m) < ADAM_FLOOR
        assert d[~tiny].max(initial=0) <= tol * max(1.0, np.abs(w).max())
        assert d[tiny].max(initial=0) <= 2 * LR


def test_sharded_microbatch_step_matches_the_single_shot_step(four_ranks):
    for res in four_ranks:
        assert res["mesh"] == (2, 2)
        loss1 = res["plain1"][0]
        loss2 = res["sharded2"][0]
        assert abs(loss2 - loss1) <= REL_TOL * abs(loss1), (loss1, loss2)
    _params_within(four_ranks[0]["sharded2"][1], four_ranks[0]["plain1"][1],
                   REL_TOL)


def test_plain_microbatch_pair_agrees(four_ranks):
    (l1, p1), (l2, p2) = four_ranks[0]["plain1"], four_ranks[0]["plain2"]
    assert abs(l1 - l2) <= PLAIN_TOL, (l1, l2)
    _params_within(p2, p1, PLAIN_TOL)


def test_microbatch_on_a_one_rank_mesh(one_rank_group):  # noqa: F811
    """The input of ROADMAP Queue C 4."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model_zoo import build_model
    cfg = _cfg()
    batch = _batch(cfg, 4, 16)
    p0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mesh = make_host_mesh(model=1, device="cpu")
    l_sh, p_sh = _step(cfg, p0, batch, 2, mesh)
    l_1, p_1 = _step(cfg, p0, batch, 1)
    assert abs(l_sh - l_1) <= PLAIN_TOL
    _params_within(p_sh, p_1, PLAIN_TOL)


def test_split_keeps_each_ranks_rows_and_refuses_a_ragged_split(
        one_rank_group):  # noqa: F811
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import distribute_batch, \
        logical_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.state import split_microbatches
    mesh = make_host_mesh(model=1, device="cpu")
    plan = logical_rules(mesh, mode="train")
    toks = torch.arange(24, dtype=torch.int32).reshape(6, 4)
    parts = split_microbatches(distribute_batch({"tokens": toks}, plan), 3)
    assert [p["tokens"].shape for p in parts] == [torch.Size((2, 4))] * 3
    assert all(isinstance(p["tokens"], DTensor) for p in parts)
    for i, p in enumerate(parts):       # one rank: the contiguous split
        assert torch.equal(p["tokens"].to_local(), toks[2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="tokens: 6 rows on each rank"):
        split_microbatches({"tokens": toks}, 4)


def _fake_trace(rank, world, init_file):
    """The per-rank program of the sharded microbatch=2 step on a fake group
    of 4 ranks: (kind, dtype) of every collective's operand."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    from repro_torch.core.hlo_analysis import C10D_KINDS, ProgramRecorder
    from repro_torch.core.unit_of_work import op_name
    from repro_torch.distributed.sharding import (logical_rules,
                                                  params_shardings,
                                                  use_rules)
    from repro_torch.launch.dryrun import (_batch_shardings, _fake_tree,
                                           _spec_struct)
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.state import init_train_state, make_train_step
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    plan = logical_rules(mesh, mode="train")
    cfg = _cfg()
    rec = ProgramRecorder()
    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(plan):
        model = build_model(cfg, plan, device="cpu")
        params = _fake_tree(_spec_struct(model.specs(), torch.float32),
                            params_shardings(mesh, plan, model.axes()),
                            "cpu")
        meta = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
                for k in ("tokens", "labels")}
        batch = _fake_tree(meta, _batch_shardings(mesh, plan, meta), "cpu")
        opt = AdamWConfig(lr=LR)
        state = init_train_state(model, params, opt)
        step = make_train_step(model, opt, constant(LR), microbatch=2,
                               instrument=False)
        with rec:
            step(state, batch)
    return [(op_name(op), str(op.args[0].meta["val"].dtype))
            for op in rec.ops if op_name(op) in C10D_KINDS]


def test_fake_rank_trace_gathers_no_batch_rows():
    from _torch_port import run_ranks
    (colls,) = run_ranks(_fake_trace, 1, timeout=180)
    assert colls, "the sharded step issues collectives"
    assert not [c for c in colls if "int" in c[1]], colls


def test_remat_recomputes_under_the_plan_on_another_thread():
    """The backward of CUDA tensors runs on a thread of its own, which does
    not see the forward thread's plan; a rematerialised layer must still
    recompute under it (on the card the recomputed layer placed its tensors
    otherwise, and the checkpoint's saved shapes did not match)."""
    import threading
    from repro_torch.distributed.sharding import (active_rules,
                                                  logical_rules, use_rules)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import _maybe_remat
    plan = logical_rules(make_production_mesh(), mode="train")
    seen = []

    def layer(x):
        seen.append(active_rules())
        return torch.tanh(x) * 2
    x = torch.ones(3, requires_grad=True)
    with use_rules(plan), torch.enable_grad():
        y = _maybe_remat(layer, _cfg())(x).sum()
    grads = []
    t = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(grads) == 1
    assert seen == [plan, plan]           # the forward and the recompute
