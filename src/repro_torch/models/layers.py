# Counterpart of src/repro/models/layers.py.  Not ported yet: ``axes_tree``
# (sharding axes have no use on one device), ``l2norm``, and int8 weights:
# ``ParamSpec.dtype``, the int8 branch of ``get_kernel``, ``quantize_specs``
# and ``quantize_params``.
"""Parameter machinery + elementary layers (plain functions on tensors).

Parameters are nested dicts of tensors with the key names and shapes of the
JAX package.  Every leaf is declared through a :class:`ParamSpec`; the
logical axis names are kept so that the two packages' specs read alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Param spec / initialisation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | scaled | custom
    scale: float = 1.0
    # init_fn(generator, shape, device) -> float32 tensor
    init_fn: Optional[Callable[..., torch.Tensor]] = None

    def instantiate(self, gen: torch.Generator, dtype, device) -> torch.Tensor:
        if self.init_fn is not None:
            return self.init_fn(gen, self.shape, device).to(dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "scaled":
            fan_in = self.shape[0] if self.shape else 1
            std = self.scale / math.sqrt(max(fan_in, 1))
        else:
            std = self.scale * 0.02
        return (std * normal(gen, self.shape, device)).to(dtype)


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 drawn on the generator's own device, then moved."""
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[ParamSpec], Any], specs: Dict[str, Any]):
    """Apply ``fn`` to every ParamSpec leaf of a nested dict, in key order."""
    return {k: fn(v) if is_spec(v) else map_specs(fn, v)
            for k, v in specs.items()}


def init_tree(gen: torch.Generator, specs: Dict[str, Any], dtype,
              device) -> Params:
    """Instantiate a (nested) dict of ParamSpec into tensors.  One generator
    is consumed leaf by leaf in key order, so a seed fixes the whole tree."""
    return map_specs(lambda s: s.instantiate(gen, dtype, device), specs)


def stack_specs(specs: Dict[str, Any], n: int,
                axis_name: str = "layer") -> Dict[str, Any]:
    """Add a leading stacked-layer dimension to every spec."""
    return map_specs(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=(axis_name,) + s.axes), specs)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of a nested dict, in key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, i: int):
    """Slice ``[i]`` off the leading (stacked layer) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            *, plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if plus_one:                       # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (y * scale).to(dt)


# ---------------------------------------------------------------------------
# Projections / embeddings / MLP
# ---------------------------------------------------------------------------


def dense_specs(d_in: int, d_out: int, axes: Tuple[Optional[str], ...],
                *, bias: bool = False, init: str = "scaled",
                scale: float = 1.0) -> Dict[str, ParamSpec]:
    out = {"kernel": ParamSpec((d_in, d_out), axes, init, scale)}
    if bias:
        out["bias"] = ParamSpec((d_out,), (axes[-1],), "zeros")
    return out


def get_kernel(params: Params, compute_dtype) -> torch.Tensor:
    """The projection's kernel in compute dtype (int8 weights: not ported)."""
    if "kernel_q" in params:
        raise NotImplementedError(
            "int8 weight-only quantisation is not ported yet (ROADMAP.md, "
            "Queue A: enc-dec, VLM, int8 weights and cache)")
    return params["kernel"].to(compute_dtype)


def dense(params: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    if compute_dtype is None:
        compute_dtype = x.dtype
    y = x.to(compute_dtype) @ get_kernel(params, compute_dtype)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def embed_lookup(params: Params, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    # gather first, cast after: the same values as casting the whole table
    return params["embedding"][tokens].to(compute_dtype)


def unembed(params: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    emb = params["embedding"].to(compute_dtype)
    return x.to(compute_dtype) @ emb.T


ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def mlp_specs(d: int, f: int, *, glu: bool = True) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "wi": dense_specs(d, f, ("embed", "mlp")),
        "wo": dense_specs(f, d, ("mlp", "embed")),
    }
    if glu:
        specs["wg"] = dense_specs(d, f, ("embed", "mlp"))
    return specs


def mlp(params: Params, x: torch.Tensor, act: str,
        compute_dtype) -> torch.Tensor:
    h = dense(params["wi"], x, compute_dtype)
    h = ACTS[act](h)
    if "wg" in params:
        h = h * dense(params["wg"], x, compute_dtype)
    return dense(params["wo"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each [..., S, 1, hd/2] in f32, for positions
    broadcastable to [..., S].  They depend on the positions alone, so a
    caller that runs many layers at the same positions makes them once."""
    freqs = rope_frequencies(head_dim, theta, positions.device)   # [hd/2]
    angles = positions[..., None].float() * freqs             # [..., S, hd/2]
    angles = angles[..., None, :]                             # head axis
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Split
    halves (not interleaved pairs); angles in f32.  ``tables``: the
    ``rope_tables`` of these positions, where the caller has them."""
    cos, sin = (rope_tables(positions, x.shape[-1], theta)
                if tables is None else tables)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)
