"""The port's distributed modules across ranks on the CPU: spawned gloo
process groups (`_torch_port.run_ranks`, each group under a timeout), one
group for the collectives and one for the sharded train step, each running
several checks whose results the tests below read.

- `gpipe` on 4 stages against sequential apply, within 1e-5.
- `compressed_psum` on 4 ranks, bit-equal to numpy's shared-max-scale sum of
  the 4 shards; `meter_psum` equal to the sum of the 4 meters.
- The sharded train step: reduced qwen3-1.7b on a (data 2, model 2) mesh
  (2D FSDP × TP), 3 steps in f32, against the single-rank port step from the
  same parameters.  The JAX package's test holds losses within 2e-2
  relative; the two runs compute the same f32 function in other reduction
  orders (sums over 2 shards, gathered rows), so they agree to rounding:
  losses within 1e-5 relative, and every updated parameter within 2e-4 of
  its leaf's largest value, outside Adam's eps elements (where the first
  moment is below 1e-7 rounding sets the step; there within 2·lr a step).
  The block table and the step's unit of work are the same.
- Reduced olmoe-1b-7b, one step on that mesh with the `experts` axis
  sharded over "model": the same loss, expert token counts and dropped
  tokens as the single-rank step.
- Elastic restore: the (2, 2) state after 3 steps checkpointed and restored
  onto a (4, 1) mesh: every full tensor bit-equal, and the loss of the next
  batch equal within 1e-5 relative.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

LR = 1e-3
ADAM_FLOOR = 1e-7
LOSS_TOL = 1e-5
PARAM_TOL = 2e-4


# ---------------------------------------------------------------------------
# group 1: the collectives
# ---------------------------------------------------------------------------


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pipeline_inputs():
    S, M, B, D = 4, 6, 2, 8
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(S, D, D)) * 0.3).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(S, D)) * 0.1).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(M, B, D)).astype(np.float32))
    return w, b, xs


def _grad_shards(rank: int):
    """This rank's gradient and error-feedback trees (numpy, from a seed)."""
    rng = np.random.default_rng(100 + rank)
    g = {"w": (rng.normal(size=(6, 5)) * (rank + 1)).astype(np.float32),
         "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    e = {"w": (rng.normal(size=(6, 5)) * 1e-2).astype(np.float32),
         "b": {"c": (rng.normal(size=(7,)) * 1e-2).astype(np.float32)}}
    return g, e


def _collectives_rank(rank, world, init_file):
    from repro_torch.core.meter import meter_psum
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.grad_compress import compressed_psum
    init_process_group(init_file, rank, world, device="cpu", timeout_s=60)
    out = {}

    w, b, xs = _pipeline_inputs()
    piped = gpipe(_stage_fn)({"w": w[rank], "b": b[rank]}, xs)
    ref = xs
    for s in range(w.shape[0]):
        ref = torch.stack([_stage_fn({"w": w[s], "b": b[s]}, ref[m])
                           for m in range(xs.shape[0])])
    out["gpipe_err"] = float(torch.max(torch.abs(piped - ref)))

    g, e = _grad_shards(rank)
    mean, new_ef = compressed_psum(tree_map(torch.from_numpy, g),
                                   tree_map(torch.from_numpy, e))
    out["psum"] = tree_map(lambda t: t.numpy(), mean)
    out["ef"] = tree_map(lambda t: t.numpy(), new_ef)

    meter = {"uow": torch.tensor(2 ** 33 + rank, dtype=torch.int64),
             "counts": torch.arange(5, dtype=torch.int32) * (rank + 1),
             "steps": torch.tensor(3, dtype=torch.int32)}
    summed = meter_psum(meter)
    out["meter"] = {k: v.numpy() for k, v in summed.items()}
    out["meter_dtypes"] = {k: str(v.dtype) for k, v in summed.items()}
    out["meter_kept"] = int(meter["uow"]) == 2 ** 33 + rank
    return out


@pytest.fixture(scope="module")
def collectives():
    from _torch_port import run_ranks
    return run_ranks(_collectives_rank, 4, timeout=180)


def test_gpipe_matches_sequential_on_4_ranks(collectives):
    for r in collectives:
        assert r["gpipe_err"] < 1e-5, r["gpipe_err"]


def _numpy_shared_scale_sum(leaves_g, leaves_e):
    """numpy's shared-max-scale int8 sum of the ranks' shards of one leaf:
    (mean, each rank's new error feedback)."""
    targets = [g + e for g, e in zip(leaves_g, leaves_e)]
    gmax = np.float32(max(np.max(np.abs(t)) for t in targets))
    scale = np.maximum(gmax, np.float32(1e-30)) / np.float32(127.0)
    qs = [np.clip(np.round(t / scale), -127, 127).astype(np.int8)
          for t in targets]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0)
    mean = (total.astype(np.float32) * scale) / np.float32(len(qs))
    efs = [t - q.astype(np.float32) * scale for t, q in zip(targets, qs)]
    return mean, efs


def test_compressed_psum_bit_equal_to_numpy(collectives):
    shards = [_grad_shards(r) for r in range(4)]
    for path in (("w",), ("b", "c")):
        def leaf(tree):
            for k in path:
                tree = tree[k]
            return tree
        mean, efs = _numpy_shared_scale_sum([leaf(g) for g, _ in shards],
                                            [leaf(e) for _, e in shards])
        assert mean.dtype == np.float32
        for r, res in enumerate(collectives):
            np.testing.assert_array_equal(leaf(res["psum"]).view(np.uint32),
                                          mean.view(np.uint32))
            np.testing.assert_array_equal(leaf(res["ef"]).view(np.uint32),
                                          efs[r].view(np.uint32))
        # the mean is within the int8 grid's half step of the true mean
        true = np.mean([leaf(g) + leaf(e) for g, e in shards], axis=0)
        gmax = max(np.abs(leaf(g) + leaf(e)).max() for g, e in shards)
        assert np.abs(mean - true).max() <= gmax / 127 / 2 + 1e-6


def test_meter_psum_sums_every_counter(collectives):
    want = {"uow": sum(2 ** 33 + r for r in range(4)),
            "counts": np.arange(5) * sum(r + 1 for r in range(4)),
            "steps": 12}
    for res in collectives:
        assert int(res["meter"]["uow"]) == want["uow"]
        np.testing.assert_array_equal(res["meter"]["counts"], want["counts"])
        assert int(res["meter"]["steps"]) == want["steps"]
        assert res["meter_dtypes"] == {"uow": "torch.int64",
                                       "counts": "torch.int32",
                                       "steps": "torch.int32"}
        assert res["meter_kept"]          # the input meter is not changed


# ---------------------------------------------------------------------------
# group 2: the sharded train step, MoE, elastic restore
# ---------------------------------------------------------------------------


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).int()
    return {"tokens": toks, "labels": toks.roll(-1, dims=1)}


def _param_devs(plain, sharded, mu):
    """Per leaf: max |sharded - plain| outside Adam's eps elements over the
    leaf's largest value, and max inside them."""
    from repro_torch.distributed.sharding import to_plain
    from repro_torch.models.layers import tree_leaves
    out = []
    for p, q, m in zip(tree_leaves(plain), tree_leaves(sharded),
                       tree_leaves(mu)):
        p, q, m = p.detach(), to_plain(q).detach(), m.detach()
        tiny = m.abs() < ADAM_FLOOR
        d = (q - p).abs()
        scale = max(1.0, float(p.abs().max()))
        out.append((float(d[~tiny].max()) / scale if (~tiny).any() else 0.0,
                    float(d[tiny].max()) if tiny.any() else 0.0))
    return out


def _train_on_mesh(arch, mesh, batches, *, table=True):
    """(plain run, sharded run): each a dict of per-step losses and aux,
    the final state, the block table; both from the same parameters."""
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core.blocks_lm import build_block_table
    from repro_torch.distributed.sharding import (distribute,
                                                  distribute_batch,
                                                  logical_rules,
                                                  params_shardings, use_rules)
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train.state import init_train_state, make_train_step
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              attention_impl="chunked", ssm_impl="chunked")
    b, s = batches[0]["tokens"].shape
    shape = ShapeConfig("t", "train", s, b)
    opt = AdamWConfig(lr=LR)
    runs = {}
    plan = logical_rules(mesh, mode="train")
    p0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for name in ("plain", "sharded"):
        with use_rules(plan if name == "sharded" else None):
            model = build_model(cfg, plan if name == "sharded" else None,
                                device="cpu")
            tab = build_block_table(model, shape) if table else None
            params = tree_map(lambda t: t.clone(), p0)
            feed = batches
            if name == "sharded":
                params = distribute(params, params_shardings(
                    mesh, plan, model.axes()))
                feed = [distribute_batch(bt, plan) for bt in batches]
            state = init_train_state(model, params, opt, tab)
            step = make_train_step(model, opt, constant(LR), table=tab)
            losses, auxes = [], []
            for bt in feed:
                state, met, aux = step(state, bt)
                losses.append(float(met["loss"]))
                auxes.append({k: v.numpy() for k, v in aux.items()})
        runs[name] = dict(losses=losses, aux=auxes, state=state, table=tab,
                          model=model, plan=plan)
    return runs


def _leaves(tree):
    """The tensor leaves of a train state (dicts and NamedTuples)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _train_rank(rank, world, init_file):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import (distribute_batch,
                                                  logical_rules,
                                                  params_shardings,
                                                  sharded_region, to_plain,
                                                  use_rules)
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig, OptState, opt_state_axes
    from repro_torch.train.state import TrainState
    init_process_group(init_file, rank, world, device="cpu", timeout_s=120)
    mesh = make_host_mesh(model=2, device="cpu")
    out = {"mesh": tuple(mesh.shape)}

    batches = [_batch(reduced(get_config("qwen3-1.7b")), 8, 32, i)
               for i in range(4)]
    runs = _train_on_mesh("qwen3-1.7b", mesh, batches[:3])
    plain, sh = runs["plain"], runs["sharded"]
    out["qwen_losses"] = (plain["losses"], sh["losses"])
    out["qwen_devs"] = _param_devs(plain["state"].params, sh["state"].params,
                                   plain["state"].opt.mu)
    out["qwen_table"] = (plain["table"].names == sh["table"].names,
                         plain["table"].step_uow(), sh["table"].step_uow())
    out["qwen_meter"] = (int(plain["state"].meter["uow"]),
                         int(sh["state"].meter["uow"]))
    leaf = tree_leaves(sh["state"].params)[0]
    mu = tree_leaves(sh["state"].opt.mu)[0]
    out["dtensor_state"] = (isinstance(leaf, DTensor) and
                            isinstance(mu, DTensor) and
                            mu.placements == leaf.placements)

    # elastic restore: the (2, 2) state saved, restored onto (4, 1)
    ck = Checkpointer(os.path.join(os.path.dirname(init_file), f"ck{rank}"),
                      process_index=rank, async_save=False)
    ck.save(3, sh["state"])
    mesh4 = init_device_mesh("cpu", (world, 1),
                             mesh_dim_names=("data", "model"))
    plan4 = logical_rules(mesh4, mode="train")
    pshard = params_shardings(mesh4, plan4, sh["model"].axes())
    oshard = params_shardings(mesh4, plan4, opt_state_axes(
        sh["model"].axes(), AdamWConfig(lr=LR)))
    shardings = TrainState(None, pshard,
                           OptState(None, oshard.mu, oshard.nu,
                                    oshard.master), None, None)
    restored, _ = ck.restore(plain["state"], 3, shardings=shardings)
    out["restore_files"] = sorted(os.listdir(os.path.join(
        os.path.dirname(init_file), f"ck{rank}", "step_00000003")))
    same = []
    for a, b in zip(_leaves(sh["state"]), _leaves(restored)):
        same.append(torch.equal(to_plain(a).detach(), to_plain(b).detach()))
    out["restore_n_leaves"] = len(same)
    for t in tree_leaves(restored.params):
        same.append(isinstance(t, DTensor) and t.device_mesh is mesh4)
    out["restore_bit_equal"] = all(same)

    def next_loss(model, params, plan):
        bt = distribute_batch(batches[3], plan)
        with use_rules(plan), torch.no_grad(), sharded_region(params):
            return float(to_plain(model.loss(params, bt)[0]))
    out["next_loss"] = (next_loss(sh["model"], sh["state"].params,
                                  sh["plan"]),
                        next_loss(sh["model"], restored.params, plan4))
    del runs, restored

    # MoE: one step with the experts sharded over "model"
    olmoe = reduced(get_config("olmoe-1b-7b"))
    runs = _train_on_mesh("olmoe-1b-7b", mesh, [_batch(olmoe, 8, 32, 7)],
                          table=False)
    out["moe_experts_spec"] = runs["sharded"]["plan"].spec(
        ("experts", "embed", "expert_mlp"))
    out["moe_losses"] = (runs["plain"]["losses"], runs["sharded"]["losses"])
    out["moe_aux"] = (runs["plain"]["aux"][0], runs["sharded"]["aux"][0])
    out["moe_devs"] = _param_devs(runs["plain"]["state"].params,
                                  runs["sharded"]["state"].params,
                                  runs["plain"]["state"].opt.mu)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def sharded_train():
    from _torch_port import run_ranks
    return run_ranks(_train_rank, 4, timeout=300)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_sharded_train_step_matches_the_single_rank_step(sharded_train):
    for res in sharded_train:
        assert res["mesh"] == (2, 2)
        plain, sharded = res["qwen_losses"]
        assert len(sharded) == 3
        for a, b in zip(sharded, plain):
            assert _rel(a, b) < LOSS_TOL, (plain, sharded)
        assert plain[-1] < plain[0]
        for outside, inside in res["qwen_devs"]:
            assert outside <= PARAM_TOL and inside <= 2 * LR * 3
        assert res["dtensor_state"]


def test_sharded_block_table_and_unit_of_work_are_the_single_ranks(
        sharded_train):
    for res in sharded_train:
        same_names, uow1, uow2 = res["qwen_table"]
        assert same_names and uow1 == uow2
        assert res["qwen_meter"][0] == res["qwen_meter"][1] == 3 * round(uow1)


def test_elastic_restore_onto_another_mesh_shape(sharded_train):
    for rank, res in enumerate(sharded_train):
        assert res["restore_files"] == [f"arrays_p{rank}.npz",
                                        "manifest.json"]
        assert res["restore_bit_equal"]
        assert res["restore_n_leaves"] > 3 * 10
        on_2x2, on_4x1 = res["next_loss"]
        assert _rel(on_4x1, on_2x2) < LOSS_TOL, res["next_loss"]


def test_moe_step_with_sharded_experts(sharded_train):
    for res in sharded_train:
        assert res["moe_experts_spec"] == ("model", "data", None)
        (plain,), (sharded,) = res["moe_losses"]
        assert _rel(sharded, plain) < LOSS_TOL
        a, b = res["moe_aux"]
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(b["expert_tokens"], a["expert_tokens"])
        assert int(b["expert_tokens"].sum()) > 0
        assert int(b["dropped_tokens"]) == int(a["dropped_tokens"])
        for k in ("router_aux_loss", "nll_mean"):
            assert _rel(float(b[k]), float(a[k])) < LOSS_TOL, k
        for outside, inside in res["moe_devs"]:
            assert outside <= PARAM_TOL and inside <= 2 * LR
