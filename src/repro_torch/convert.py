"""Parameters and train states of the JAX package, as numpy arrays, turned
into the port's (no counterpart in ``src/repro``).

The two packages share one parameter layout, so the conversion is leaf by
leaf: every key and shape is checked against the port's specs and anything
unknown or missing raises.  bf16 leaves arrive as ``ml_dtypes`` arrays and go
through float32, which is exact.  A spec with its own dtype (int8 weights:
the int8 payload and its f32 scale) keeps it whatever the model's dtype; an
int4 payload (``ml_dtypes.int4`` leaves) is read as int8 and packed two
values a byte (`layers.pack_int4`); the enc-dec family's
``enc_layers``/``dec_layers`` stacks and ``enc_pos``/``dec_pos`` tables
carry over like any other leaf.  The module imports no JAX: a caller turns
the pytree into numpy first (``jax.tree.map(np.asarray, params)``).

A train state carries over whole: parameters, the optimizer's step, moments
and master copy, the step, the PRNG key (opaque) and the work meter, whose
two uint32 limbs become the port's one int64 counter.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, dtype_of
from repro_torch.core.meter import meter_from_limbs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import model_specs


def _leaf(path: str, arr, spec: L.ParamSpec, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(spec.shape):
        raise ValueError(f"parameter {path}: shape {tuple(a.shape)}, "
                         f"expected {tuple(spec.shape)}")
    if spec.dtype == "int4":
        values = torch.from_numpy(a.astype(np.int8))
        return L.pack_int4(values, L.int4_axis(spec.axes)).to(device)
    if a.dtype.kind not in "fiu":          # ml_dtypes bfloat16 has kind 'V'
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))         # a copy: the source may be read-only
    return t.to(device=device, dtype=L.spec_dtype(spec) or dtype)


def _walk(path: str, tree, specs, device, dtype):
    if L.is_spec(specs):
        if isinstance(tree, dict):
            raise KeyError(f"parameter {path}: a leaf was expected, got keys "
                           f"{sorted(tree)}")
        return _leaf(path, tree, specs, device, dtype)
    if not isinstance(tree, dict):
        raise KeyError(f"parameter {path}: keys {sorted(specs)} were expected, "
                       "got a leaf")
    unknown = sorted(set(tree) - set(specs))
    missing = sorted(set(specs) - set(tree))
    if unknown:
        raise KeyError(f"parameter {path or '<root>'}: unknown leaf or group "
                       f"{unknown}")
    if missing:
        raise KeyError(f"parameter {path or '<root>'}: missing {missing}")
    return {k: _walk(f"{path}/{k}" if path else k, tree[k], specs[k], device,
                     dtype) for k in specs}


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: DeviceLike = None, dtype=None) -> Dict[str, Any]:
    """``tree``: the JAX package's parameter pytree for ``cfg`` as nested
    dicts of numpy arrays.  ``dtype=None`` keeps ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype) if dtype is None else dtype
    specs = model_specs(cfg, T.ModelDims.make(cfg, 1))
    return _walk("", tree, specs, dev, dtype)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse, for round trips: float32 numpy leaves."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def train_state_from_numpy(state, cfg: ArchConfig, device: DeviceLike = None):
    """``state``: the JAX package's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``), read by attribute.  Returns the
    port's ``TrainState`` on ``device``, parameters requiring grad."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.state import TrainState
    dev = resolve_device(device)
    params = params_from_numpy(state.params, cfg, dev)
    for p in L.tree_leaves(params):
        p.requires_grad_(True)
    f32 = torch.float32
    opt = state.opt
    has_master = np.asarray(L.tree_leaves(opt.master)[0]).size > 0
    master = (params_from_numpy(opt.master, cfg, dev, f32) if has_master
              else L.map_specs(lambda s: torch.zeros((0,), device=dev),
                               model_specs(cfg, T.ModelDims.make(cfg, 1))))

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32).to(dev)

    opt_t = OptState(scalar(opt.step), params_from_numpy(opt.mu, cfg, dev, f32),
                     params_from_numpy(opt.nu, cfg, dev, f32), master)
    meter = (meter_from_limbs(state.meter, dev) if state.meter is not None
             else None)
    return TrainState(scalar(state.step), params, opt_t,
                      np.asarray(state.rng, np.uint32), meter)
