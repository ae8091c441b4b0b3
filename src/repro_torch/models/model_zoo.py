# Counterpart of src/repro/models/model_zoo.py: every family, with int8 or
# int4 weights and an int8 cache, under a sharding plan, and the dry-run's
# input specs (`input_specs`, `cache_specs_struct`: meta tensors where the
# reference has ShapeDtypeStructs).  `cross_entropy` of DTensor logits gathers the
# vocabulary first (`_cross_entropy_sharded`); the reference leaves that to
# its partitioner.
"""Unified model facade: build an architecture, expose init / loss /
forward / prefill / decode plus cache construction.

``Model`` holds no parameters: as in the reference they are a nested dict of
tensors that the caller owns and passes to every call.  ``device`` is fixed
when the model is built and is where ``init`` and ``init_cache`` allocate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig, ShapeConfig, dtype_of
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode as D
from repro_torch.models import encdec as ED
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelDims


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, *, z_loss: float = 1e-4):
    """CE with z-loss, in f32, as the reference.  logits: [B,S,V], labels:
    [B,S].  Returns (loss, nll [B,S]).

    The max is detached where it shifts the logits and not where it is added
    back, as in the reference, so the gradients are the reference's.  The
    correct-class logit is gathered (a one-hot over the vocabulary would be
    an int64 tensor of 2.5 GB at qwen3-1.7b's train shape).  DTensor
    logits take `_cross_entropy_sharded`."""
    if isinstance(logits, DTensor):
        return _cross_entropy_sharded(logits, labels, z_loss=z_loss)
    nll, lse = _nll_lse(logits, labels)
    return _ce_loss(nll, lse, z_loss), nll


def _nll_lse(logits, labels):
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    shifted = lf - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    correct = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - correct, lse


def _ce_loss(nll, lse, z_loss: float):
    loss = torch.mean(nll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def _cross_entropy_sharded(logits: DTensor, labels, *, z_loss: float):
    """CE of DTensor logits.  The vocabulary is gathered: each mesh dim keeps
    its shard of the batch or sequence dims and replicates the vocab dim.
    Then each rank computes the per-token nll and log-sum-exp of its local
    rows with the plain code above, so values and gradients are the
    reference's, the detached max included; the means run on the DTensors
    (a sum over the ranks)."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = tuple(p if isinstance(p, Shard) and p.dim < last else Replicate()
               for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, pl)
    nll_l, lse_l = _nll_lse(logits.to_local(), labels.to_local())
    nll, lse = (DTensor.from_local(t, mesh, pl, run_check=False,
                                   shape=labels.shape, stride=labels.stride())
                for t in (nll_l, lse_l))
    return _ce_loss(nll, lse, z_loss), nll


def model_specs(cfg: ArchConfig, dims: ModelDims):
    """The ParamSpec tree of ``cfg``: the enc-dec or decoder-LM layout, its
    kernels quantized where ``weight_quant`` says so."""
    if cfg.family == "encdec":
        specs = ED.encdec_specs(cfg, dims)
    else:
        specs = T.lm_specs(cfg, dims)
    if cfg.weight_quant in ("int8", "int4"):
        specs = L.quantize_specs(specs, cfg.weight_quant)
    return specs


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    dims: ModelDims
    device: torch.device

    # ---- params ----------------------------------------------------------
    def specs(self):
        return model_specs(self.cfg, self.dims)

    def init(self, gen: torch.Generator):
        """Random parameters drawn from ``gen`` (where the JAX package takes
        a PRNG key), allocated on the model's device."""
        return L.init_tree(gen, self.specs(), dtype_of(self.cfg.param_dtype),
                           self.device)

    def axes(self):
        """The logical-axes tree of the parameters (for `quantize_params`)."""
        return L.axes_tree(self.specs())

    # ---- forward ---------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                rng: Optional[torch.Generator] = None):
        return self._forward(params, batch, rng)

    def _forward(self, params, batch, rng):
        """(logits, aux) in the caller's grad mode: the enc-dec family from
        ``batch["frames"]``, the VLM with ``batch["patches"]`` if given."""
        params = self.params_on_device(params)
        if self.cfg.family == "encdec":
            return ED.encdec_forward(params, self.cfg, self.dims,
                                     batch["tokens"], batch["frames"])
        return T.lm_forward(params, self.cfg, self.dims, batch["tokens"],
                            patch_embeds=batch.get("patches"), rng=rng)

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             rng: Optional[torch.Generator] = None):
        """(loss, aux) with ``aux["nll_mean"]``; differentiable (the forward
        runs in the caller's grad mode, rematerialised under grad).  MoE
        adds the router's auxiliary loss, averaged over the layers.
        ``rng``: the router jitter's generator (models/moe.py)."""
        logits, aux = self._forward(params, batch, rng)
        loss, nll = cross_entropy(logits, batch["labels"],
                                  self.cfg.vocab_size)
        if "router_aux_loss" in aux:
            loss = loss + aux["router_aux_loss"] / max(self.cfg.n_layers, 1)
        aux["nll_mean"] = torch.mean(nll)
        return loss, aux

    # ---- serving ---------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int):
        cfg = self.cfg
        kv_pad = self.dims.layout.kv_pad if self.dims.layout else 0
        if cfg.mla is not None:                 # one latent a token and layer
            kv_pad = 0
        hd = cfg.attn.head_dim if cfg.attn else 0
        ssm = None
        n_kv_layers = cfg.n_layers
        if cfg.family in ("ssm", "hybrid"):
            _, nh = S.ssm_dims(cfg)
            ssm = dict(n_layers=cfg.n_layers, n_heads=nh,
                       head_dim=cfg.ssm.head_dim, d_state=cfg.ssm.d_state,
                       d_conv=cfg.ssm.d_conv, conv_dim=S.conv_dim(cfg))
        if cfg.family == "hybrid":              # one kv layer per group
            n_kv_layers = T._hybrid_groups(cfg)[1]
        return KC.init_cache(n_kv_layers, batch, max_seq, kv_pad, hd,
                             dtype_of(cfg.compute_dtype), ssm=ssm,
                             cross_len=(cfg.n_frames if cfg.family == "encdec"
                                        else 0),
                             device=self.device,
                             quant=cfg.cache_quant == "int8",
                             latent_dim=(cfg.mla.latent_dim if cfg.mla
                                         else 0))

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        params = self.params_on_device(params)
        if self.cfg.family == "encdec":
            return ED.encdec_prefill(params, self.cfg, self.dims,
                                     batch["tokens"], batch["frames"], cache)
        return D.lm_prefill(params, self.cfg, self.dims, batch["tokens"],
                            cache, patch_embeds=batch.get("patches"))

    @torch.no_grad()
    def decode_step(self, params, token, cache):
        params = self.params_on_device(params)
        if self.cfg.family == "encdec":
            return ED.encdec_decode(params, self.cfg, self.dims, token, cache)
        return D.lm_decode(params, self.cfg, self.dims, token, cache)

    # ---- dry-run specs ---------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins for every model input (no allocation), the
        reference's ShapeDtypeStructs.  Token ids are int32, as there; the
        model converts where it indexes."""
        cfg = self.cfg
        b = shape.global_batch

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")
        dt = dtype_of(cfg.compute_dtype)
        if shape.kind in ("train", "prefill"):
            s = shape.seq_len
            out = {"tokens": meta((b, s), torch.int32)}
            if shape.kind == "train":
                out["labels"] = meta((b, s), torch.int32)
            if cfg.family == "encdec":
                out["frames"] = meta((b, cfg.n_frames, cfg.d_model), dt)
            if cfg.n_patches:
                out["patches"] = meta((b, cfg.n_patches, cfg.d_model), dt)
            return out
        # decode: one new token + cache of seq_len
        return {"token": meta((b, 1), torch.int32)}

    def cache_specs_struct(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The tree of ``init_cache(global_batch, seq_len)`` as meta tensors,
        whatever the model's device."""
        meta = dataclasses.replace(self, device=torch.device("meta"))
        return meta.init_cache(shape.global_batch, shape.seq_len)

    # ----------------------------------------------------------------------
    def params_on_device(self, params):
        """Raise early, by name, if parameters lie on another device than
        the model's (no silent transfer on the hot path)."""
        leaf = params["final_norm"]["scale"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"parameters on {leaf.device}, model on "
                             f"{self.device}")
        return params

    def param_count(self, params=None) -> int:
        if params is not None:
            return L.param_count(params)
        return self.cfg.param_count()


def build_model(cfg: ArchConfig, plan=None, *,
                device: DeviceLike = None) -> Model:
    """``device=None`` means the card; ``device="cpu"`` must be asked for.
    Under a ``plan`` the head and vocab padding follow its tensor-parallel
    size, as the reference's."""
    T.require_ported(cfg)
    tp = plan.tp_size if plan is not None else 1
    return Model(cfg, ModelDims.make(cfg, tp), resolve_device(device))
