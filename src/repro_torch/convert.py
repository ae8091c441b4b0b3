"""Parameters of the JAX package, as nested dicts of numpy arrays, turned into
the port's parameters (no counterpart in ``src/repro``).

The two packages share one parameter layout, so the conversion is leaf by
leaf: every key and shape is checked against the port's specs and anything
unknown or missing raises.  bf16 leaves arrive as ``ml_dtypes`` arrays and go
through float32, which is exact.  The module imports no JAX: a caller turns
the pytree into numpy first (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, dtype_of
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _leaf(path: str, arr, spec: L.ParamSpec, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(spec.shape):
        raise ValueError(f"parameter {path}: shape {tuple(a.shape)}, "
                         f"expected {tuple(spec.shape)}")
    if a.dtype.kind not in "fiu":          # ml_dtypes bfloat16 has kind 'V'
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))         # a copy: the source may be read-only
    return t.to(device=device, dtype=dtype)


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
    specs = T.lm_specs(cfg, T.ModelDims.make(cfg, 1))
    return _walk("", tree, specs, dev, dtype)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse, for round trips: float32 numpy leaves."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()
