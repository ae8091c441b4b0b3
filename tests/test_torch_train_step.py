"""The port's train step against the JAX package's, on the CPU at the reduced
size (f32), from the JAX package's state converted leaf by leaf
(`convert.train_state_from_numpy`) and the same batches: qwen3-1.7b,
mamba2-780m, zamba2-1.2b (5 layers: two hybrid groups and a remainder),
olmoe-1b-7b and llama4-scout-17b-a16e (the loss with the router's
auxiliary term; router jitter 0, as every shipped config has it).

Tolerances.  f32 model math is held to 2e-4 (`tests/test_models.py`'s
cross-implementation tolerance) relative to max(1, the largest magnitude of
the JAX value).  Two effects that both packages share need a rule of their
own:

- A stack of random-weight Mamba2 layers amplifies f32 rounding, and the
  chunked SSD's gradient through cumsum(dt·A) carries more of it than the
  step-by-step recurrence (`tests/test_torch_train.py::
  test_ssd_chunked_gradients_are_as_accurate_as_the_jax_package` holds both
  chunked versions to a float64 oracle).  So for the SSM and hybrid families
  a gradient, the gradient norm or an updated parameter is held to the
  larger of 2e-4 and SSM_SPREAD × the disagreement between the JAX package's
  own two SSD algorithms (`ssm_impl="chunked"` and `"reference"`) on the
  same run.
- Adam's first steps move an element by about lr·g/(|g| + eps): where the
  gradient sits within a few eps (1e-8) of zero, its rounding decides the
  size, and even the sign, of the step.  Parameters are held as above except
  where the JAX package's first moment is below ADAM_FLOOR, and there within
  the most that the steps can move them apart (2·lr a step).
"""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_port import SSM_ARCHS, to_np
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.model_zoo import build_model as jbuild
from repro.optim import AdamWConfig as JAdam
from repro.optim import constant as jconstant
from repro.train.state import init_train_state as j_init_state
from repro.train.state import make_train_step as j_make_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import train_state_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import AdamWConfig, constant
from repro_torch.train.state import make_train_step
from test_torch_train import _batch, _flat, _rel, _train_cfg

TOL = 2e-4
SSM_SPREAD = 10
ADAM_FLOOR = 1e-7
LR = 1e-3
ARCHS = {"qwen3-1.7b": {}, **SSM_ARCHS, "olmoe-1b-7b": {},
         "llama4-scout-17b-a16e": {}}


def _grad_tol(arch, spread: float) -> float:
    return TOL if arch not in SSM_ARCHS else max(TOL, SSM_SPREAD * spread)


def _scalars(d):
    """The scalar entries of a step's metrics and aux (the MoE's
    `expert_tokens` is a vector, held in the MoE tests)."""
    return {k: float(np.asarray(v)) for k, v in d.items()
            if np.asarray(v).size == 1}


def _run_jax(jm, jstate, n):
    step = jax.jit(j_make_step(jm, JAdam(lr=LR), jconstant(LR),
                               instrument=False))
    out = []
    for i in range(n):
        jb, _ = _batch(jm.cfg, i)
        jstate, metrics, aux = step(jstate, jb)
        out.append({"params": _flat(jax.tree.map(np.asarray, jstate.params)),
                    "mu": _flat(jax.tree.map(np.asarray, jstate.opt.mu)),
                    **_scalars(metrics | aux)})
    return out


@pytest.fixture(scope="module", params=list(ARCHS))
def train_runs(request):
    """Three steps of the JAX train step (chunked; for the SSM families also
    with the reference SSD) and of the port's, from one converted state."""
    arch = request.param
    jcfg = jreduced(jget(arch), **ARCHS[arch])        # chunked, chunked
    jm = jbuild(jcfg)
    pcfg = reduced(get_config(arch), **ARCHS[arch])
    j0 = j_init_state(jm, jax.random.PRNGKey(0), JAdam(lr=LR))
    ps = train_state_from_numpy(jax.tree.map(np.asarray, j0), pcfg, "cpu")
    jax_runs = _run_jax(jm, j0, 3)
    jax_ref = (None if arch not in SSM_ARCHS else _run_jax(
        jbuild(dataclasses.replace(jcfg, ssm_impl="reference")), j0, 3))
    pm = build_model(_train_cfg(pcfg), device="cpu")
    step = make_train_step(pm, AdamWConfig(lr=LR), constant(LR),
                           instrument=False)
    port = []
    for i in range(3):
        _, pb = _batch(pcfg, i)
        ps, metrics, aux = step(ps, pb)
        # copies: the state is updated in place by the next step
        port.append({"params": {k: np.array(to_np(v))
                                for k, v in _flat(ps.params).items()},
                     "mu": {k: np.array(to_np(v))
                            for k, v in _flat(ps.opt.mu).items()},
                     **_scalars({k: v.detach().cpu() for k, v in
                                 (metrics | aux).items()})})
    return arch, jax_runs, jax_ref, port


def test_loss_and_grads_match_the_jax_package(train_runs):
    """The first step's loss, `nll_mean` and the (clipped) gradient of every
    parameter leaf, read from the first moment after one step
    (mu = (1 - b1) g)."""
    arch, jax_runs, jax_ref, port = train_runs
    j, p = jax_runs[0], port[0]
    for key in ("loss", "nll_mean"):
        assert abs(p[key] - j[key]) <= TOL * max(1.0, abs(j[key])), key
    assert sorted(p["mu"]) == sorted(j["mu"])
    b1 = AdamWConfig().b1
    for k, mu in j["mu"].items():
        want = mu / (1 - b1)
        spread = (0.0 if jax_ref is None
                  else _rel(jax_ref[0]["mu"][k] / (1 - b1), want))
        err, tol = _rel(p["mu"][k] / (1 - b1), want), _grad_tol(arch, spread)
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_the_jax_package(train_runs, n_steps):
    """Loss, gradient norm and every updated parameter leaf after 1 and 3
    steps (lr 1e-3, clip 1)."""
    arch, jax_runs, jax_ref, port = train_runs
    jmet, pmet = jax_runs[n_steps - 1], port[n_steps - 1]
    assert abs(pmet["loss"] - jmet["loss"]) <= TOL * max(1.0, jmet["loss"])
    assert pmet["lr"] == pytest.approx(jmet["lr"], rel=1e-7)
    spread = (0.0 if jax_ref is None else
              abs(jax_ref[n_steps - 1]["grad_norm"] - jmet["grad_norm"])
              / jmet["grad_norm"])
    gn_err = abs(pmet["grad_norm"] - jmet["grad_norm"]) / jmet["grad_norm"]
    assert gn_err <= _grad_tol(arch, spread), (gn_err, spread)
    want, mu, pparams = jmet["params"], jmet["mu"], pmet["params"]
    assert sorted(want) == sorted(pparams)
    for k, w in want.items():
        tiny = np.abs(mu[k]) < ADAM_FLOOR
        scale = max(1.0, np.abs(w).max())

        def dev(got):
            return np.abs(got - w)[~tiny].max(initial=0.0) / scale
        spread = (0.0 if jax_ref is None
                  else dev(jax_ref[n_steps - 1]["params"][k]))
        assert dev(pparams[k]) <= _grad_tol(arch, spread), k
        assert np.abs(pparams[k] - w)[tiny].max(initial=0.0) <= \
            2 * LR * n_steps, k
