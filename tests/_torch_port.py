"""Helpers shared by the tests of the PyTorch port: numpy inputs from a seed
handed to both packages, and parameters of the JAX package converted into the
port's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import reduced as jx_reduced
from repro.models.model_zoo import build_model as jx_build_model
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model as pt_build_model


# reduced SSM-family configs of the tests: mamba2, and a hybrid of two groups
# of two Mamba2 layers plus a remainder of one (`reduced()` sets
# attn_every = 2; with its default n_layers = 2 there would be no remainder)
SSM_ARCHS = {"mamba2-780m": {}, "zamba2-1.2b": dict(n_layers=5)}


def to_jax(a: np.ndarray, bf16: bool = False):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if bf16 else x


def to_torch(a: np.ndarray, bf16: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close_to_scale(got, want, tol: float = 2e-4) -> None:
    """max |got - want| <= tol * max(1, max |want|): for outputs whose f32
    rounding grows with their magnitude (SSM states, gated-norm blocks)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def model_pair(arch: str, jax_impl: str = "pallas", **reduce_kw):
    """(jax cfg, jax model, jax params, port cfg, port model, port params) at
    the reduced size, the port's parameters converted from the JAX ones."""
    jcfg = dataclasses.replace(jx_reduced(jx_get_config(arch), **reduce_kw),
                               attention_impl=jax_impl)
    jmodel = jx_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    pcfg = pt_reduced(pt_get_config(arch), **reduce_kw)
    pmodel = pt_build_model(pcfg, device="cpu")
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                device="cpu")
    return jcfg, jmodel, jparams, pcfg, pmodel, pparams
