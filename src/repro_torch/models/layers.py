# Counterpart of src/repro/models/layers.py; nothing of it is left unported.
# torch has no int4 storage (``torch.int4`` is a shell: one byte an element,
# no ``copy_``), so an int4 payload is stored two values a ``uint8``, packed
# along the kernel's "embed" axis (`pack_int4`), and unpacked to the compute
# dtype on use, as the reference's `get_kernel` casts its int4 leaves.
# `scope` is the port's ``jax.named_scope``: a label that a profile and the
# program's trace see (`obs.span`).
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
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.distributed.sharding import (fsdp_gather, lookup_rows,
                                              sharded_product)

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
    dtype: Optional[str] = None   # override model param dtype (int8 quant)

    def instantiate(self, gen: torch.Generator, dtype, device) -> torch.Tensor:
        if self.dtype == "int4":          # zeros, as `quantize_specs` asks
            return torch.zeros(stored_shape(self), dtype=torch.uint8,
                               device=device)
        if self.dtype is not None:
            dtype = spec_dtype(self)
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


# the storage dtype of a spec's override; an int4 payload is packed uint8
SPEC_DTYPES = {"int8": torch.int8, "int4": torch.uint8,
               "float32": torch.float32}


def spec_dtype(spec: ParamSpec):
    """The tensor dtype of a spec's override (``None`` without one)."""
    if spec.dtype is None:
        return None
    if spec.dtype not in SPEC_DTYPES:
        raise NotImplementedError(
            f"parameter dtype {spec.dtype!r} has no tensor type here")
    return SPEC_DTYPES[spec.dtype]


def int4_axis(axes: Tuple[Optional[str], ...]) -> int:
    """The axis an int4 payload is packed along: the kernel's "embed" axis,
    which every kernel has (its input axis, or its output axis where the
    input is heads, the MLP or the SSM's inner width).  d_model is a
    multiple of 64 in every config, so every plan that shards it (FSDP over
    up to 32 ranks) still divides it after halving; the heads of an output
    projection would not."""
    return axes.index("embed")


def stored_shape(spec: ParamSpec) -> Tuple[int, ...]:
    """The shape of the tensor that holds ``spec``: its own, but for an int4
    payload, whose packed axis (`int4_axis`) holds two values a byte."""
    if spec.dtype != "int4":
        return tuple(spec.shape)
    axis = int4_axis(spec.axes)
    return tuple(n // 2 if i == axis else n for i, n in enumerate(spec.shape))


def pack_int4(values: torch.Tensor, axis: int) -> torch.Tensor:
    """Integer values in [-8, 7] -> uint8, two a byte along ``axis``: value
    ``2i`` in the low nibble of byte ``i``, value ``2i + 1`` in the high one
    (two's complement nibbles), so a shard of the bytes holds a shard of the
    values."""
    v = values.to(torch.int8).movedim(axis, -1)
    if v.shape[-1] % 2:
        raise ValueError(f"int4 packing: axis {axis} of {tuple(values.shape)} "
                         "is odd")
    lo = (v[..., 0::2] & 15).to(torch.uint8)
    hi = (v[..., 1::2] & 15).to(torch.uint8)
    return (lo | (hi << 4)).movedim(-1, axis).contiguous()


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """The inverse of `pack_int4`: int8 values in [-8, 7], twice as many
    along ``axis``.  Each nibble is sign-extended by an arithmetic shift."""
    p = packed.movedim(axis, -1)
    lo = (p << 4).view(torch.int8) >> 4
    hi = p.view(torch.int8) >> 4
    v = torch.stack([lo, hi], dim=-1).flatten(-2)
    return v.movedim(-1, axis)


def _unpack_payload(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A layer's packed int4 payload as int8 values.  Its contraction axis
    is 0 (the scale has every other axis), so the packed axis is 0 where the
    payload's other axes are the scale's, else the last one.  A DTensor is
    unpacked shard by shard: a shard of the bytes is a shard of the values
    (`pack_int4`), so the placements carry over."""
    axis = 0 if tuple(q.shape[1:]) == tuple(scale.shape) else q.ndim - 1
    if not isinstance(q, DTensor):
        return unpack_int4(q, axis)
    local = unpack_int4(q.to_local(), axis)
    shape = list(q.shape)
    shape[axis] *= 2
    full = torch.Size(shape)
    return DTensor.from_local(local, q.device_mesh, q.placements,
                              run_check=False, shape=full,
                              stride=torch.empty(full, device="meta").stride())


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


def scope(name: str):
    """The label of a block (the reference's ``jax.named_scope``): an
    ``obs.span``, so a profiler's user range (as ``record_function`` opens)
    while a profiler records and no trace runs, so that
    `core.hlo_analysis.find_scope_labels` finds the block's ops in the
    profile, and a span of the program's trace while the tracer is on.
    Otherwise it does nothing: no ATen op, no launch, and no node in a
    ``make_fx`` graph (the unit of work counts every node) or a fake-tensor
    program."""
    return obs.span(name)


def init_tree(gen: torch.Generator, specs: Dict[str, Any], dtype,
              device) -> Params:
    """Instantiate a (nested) dict of ParamSpec into tensors.  One generator
    is consumed leaf by leaf in key order, so a seed fixes the whole tree."""
    return map_specs(lambda s: s.instantiate(gen, dtype, device), specs)


def axes_tree(specs: Dict[str, Any]) -> Dict[str, Any]:
    """The logical-axes tuple of every spec, in the specs' nesting."""
    return map_specs(lambda s: s.axes, specs)


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


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt)


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
    """The projection's kernel in compute dtype.  Weight-only quantization
    (serving): an int8 or int4 kernel with a per-output-channel f32 scale is
    dequantized on use, in compute dtype, as the reference does (an int4
    payload unpacked first).  A DTensor kernel is gathered over its FSDP
    mesh dims first (`fsdp_gather`)."""
    if "kernel_q" in params:
        q = fsdp_gather(params["kernel_q"])
        scale = fsdp_gather(params["kernel_scale"])
        if q.dtype == torch.uint8:
            q = _unpack_payload(q, scale)
        return q.to(compute_dtype) * scale.to(compute_dtype)[None]
    return fsdp_gather(params["kernel"]).to(compute_dtype)


def dense(params: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    if compute_dtype is None:
        compute_dtype = x.dtype
    w = get_kernel(params, compute_dtype)
    y = (sharded_product(x.to(compute_dtype), w) if isinstance(w, DTensor)
         else x.to(compute_dtype) @ w)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def _quant_reduce_axis(axes: Tuple[Optional[str], ...]) -> int:
    """Contraction (input) axis of a kernel: axis 0, or 1 when the kernel is
    layer-stacked (leading "layer" axis from stack_specs)."""
    return 1 if (axes and axes[0] == "layer") else 0


def quantize_specs(specs, qdtype: str = "int8"):
    """ParamSpec-tree transform: replace every ``kernel`` spec with an
    int8/int4 payload + per-out-channel scale specs (same logical axes, the
    scale inherits the kernel's non-contracting axes)."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "kernel" and is_spec(v) and len(v.shape) >= 2:
                    r = _quant_reduce_axis(v.axes)
                    out["kernel_q"] = dataclasses.replace(
                        v, init="zeros", dtype=qdtype)
                    out["kernel_scale"] = ParamSpec(
                        v.shape[:r] + v.shape[r + 1:],
                        v.axes[:r] + v.axes[r + 1:], "ones", dtype="float32")
                else:
                    out[k] = walk(v)
            return out
        return node
    return walk(specs)


def quantize_params(params, axes=None):
    """Real int8 symmetric per-output-channel quantization of every kernel:
    scale = max|w| / 127 along the contraction axis (f32), payload
    round(w / scale) (half to even) clipped to +-127.  ``axes`` (the
    matching logical-axes tree, ``Model.axes()``) disambiguates
    layer-stacked kernels; without it the contraction axis is assumed to be
    0.  New tensors on the parameters' device; the input is not changed."""
    def walk(node, anode):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                av = anode.get(k) if isinstance(anode, dict) else None
                if k == "kernel" and isinstance(v, torch.Tensor) \
                        and v.ndim >= 2:
                    r = _quant_reduce_axis(av if av is not None else ())
                    w = v.float()
                    scale = torch.clamp(torch.amax(w.abs(), dim=r),
                                        min=1e-8) / 127.0
                    q = torch.clamp(torch.round(w / scale.unsqueeze(r)),
                                    -127, 127)
                    out["kernel_q"] = q.to(torch.int8)
                    out["kernel_scale"] = scale
                else:
                    out[k] = walk(v, av)
            return out
        return node
    return walk(params, axes)


def embed_lookup(params: Params, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    # gather first, cast after: the same values as casting the whole table
    table = params["embedding"]
    if isinstance(table, DTensor) or isinstance(tokens, DTensor):
        return lookup_rows(table, tokens).to(compute_dtype)
    return table[tokens].to(compute_dtype)


def unembed(params: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    emb = fsdp_gather(params["embedding"]).to(compute_dtype)
    if isinstance(emb, DTensor):
        return sharded_product(x.to(compute_dtype), emb.T)
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
