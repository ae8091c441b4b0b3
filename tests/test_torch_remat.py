"""``remat="selective"`` of the port against the JAX package's, on the CPU at
the reduced size (f32).  The reference checkpoints each layer with
``dots_with_no_batch_dims_saveable``: the weight products are saved, the rest
recomputed in the backward.  The port's policy saves ``mm``/``addmm`` and the
``bmm`` over a batch of one that ``torch.einsum`` makes of a weight product.

- Loss and every parameter's gradient against the JAX package's with the
  same setting, from converted parameters: 2e-4 (tests/test_models.py) of
  max(1, the largest JAX value); for mamba2-780m the larger of that and
  SSM_SPREAD x the JAX package's own spread between its two SSDs (ROADMAP's
  traps), as tests/test_torch_train_step.py holds the SSM families.
- Selective remat computes what full remat computes: the port's loss and
  gradients are bit-equal between the two.

The traced backward and the step's FLOPs: tests/test_torch_remat_trace.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port import model_pair
from test_torch_train import _batch, _flat, _rel
from test_torch_train_step import SSM_SPREAD, TOL
from repro.models.model_zoo import build_model as jbuild
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model

ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "mamba2-780m")
IMPLS = dict(attention_impl="chunked", ssm_impl="chunked")


def _jax_loss_and_grads(jcfg, jparams, batch):
    m = jbuild(jcfg)
    (loss, _), g = jax.value_and_grad(
        lambda p: m.loss(p, batch), has_aux=True)(jparams)
    return float(loss), _flat(jax.tree.map(np.asarray, g))


def _port_loss_and_grads(pcfg, pparams, batch):
    m = build_model(pcfg, device="cpu")
    params = L.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        pparams)
    leaves = L.tree_leaves(params)
    loss = m.loss(params, batch)[0]
    grads = torch.autograd.grad(loss, leaves)
    flat = _flat(params)
    by_leaf = {id(t): g for t, g in zip(leaves, grads)}
    return loss.item(), {k: by_leaf[id(t)] for k, t in flat.items()}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    jcfg, _, jp, pcfg, _, pp = model_pair(arch, jax_impl="chunked")
    jcfg = dataclasses.replace(jcfg, remat="selective", **IMPLS)
    jb, pb = _batch(pcfg, 0)
    out = {"arch": arch, "jax": _jax_loss_and_grads(jcfg, jp, jb)}
    if pcfg.family == "ssm":
        out["jax_ref"] = _jax_loss_and_grads(
            dataclasses.replace(jcfg, ssm_impl="reference"), jp, jb)
    for remat in ("selective", "full"):
        out[remat] = _port_loss_and_grads(
            dataclasses.replace(pcfg, remat=remat, **IMPLS), pp, pb)
    return out


def test_selective_loss_and_grads_match_the_jax_package(runs):
    jloss, jgrads = runs["jax"]
    ploss, pgrads = runs["selective"]
    assert abs(ploss - jloss) <= TOL * max(1.0, abs(jloss))
    assert sorted(pgrads) == sorted(jgrads)
    for key, want in jgrads.items():
        tol = TOL
        if "jax_ref" in runs:
            tol = max(TOL, SSM_SPREAD * _rel(runs["jax_ref"][1][key], want))
        err = _rel(pgrads[key], want)
        assert err <= tol, (runs["arch"], key, err, tol)


def test_selective_equals_full_remat_bit_for_bit(runs):
    (ls, gs), (lf, gf) = runs["selective"], runs["full"]
    assert ls == lf
    for key in gs:
        assert torch.equal(gs[key], gf[key]), key
