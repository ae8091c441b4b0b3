# Counterpart of src/repro/configs/base.py.  Pure data, copied; ``dtype_of``
# returns torch dtypes, and ``attention_impl`` and ``ssm_impl`` gain the value
# "cuda" (the port's default for both).  Nothing of the module is left
# unported.  The port adds fields of its own, each defaulting to the
# reference's behaviour (`PORT_ONLY_FIELDS`; `config_dict` is a config's
# dict without them at their defaults): latent attention (`MLAConfig`,
# `ArchConfig.mla`), leading dense layers (`n_dense_layers`), a shared-expert
# width apart from `d_ff` (`MoEConfig.d_shared`) and top-k gates left as
# the softmax gives them (`MoEConfig.norm_topk`).
"""Architecture / shape / run configuration dataclasses.

Every assigned architecture gets a module in ``repro_torch.configs`` exporting a
single ``CONFIG: ArchConfig``.  Shapes are the four assignment-wide workload
shapes; each config declares which shapes apply to it (``long_500k`` is only
valid for sub-quadratic-attention families, per DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                     # hidden width of each expert MLP
    n_shared_experts: int = 0         # always-on shared expert(s)
    capacity_factor: float = 1.25     # dense-dispatch capacity bound
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    d_shared: int = 0                 # the shared experts' one MLP; 0: d_ff
    norm_topk: bool = True            # renormalise the top-k gates to sum 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int                      # N in Mamba2 / SSD
    expand: int = 2                   # d_inner = expand * d_model
    head_dim: int = 64                # P; n_heads = d_inner / head_dim
    d_conv: int = 4
    chunk: int = 256                  # SSD chunk length
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False             # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False            # qwen2.5-style bias on qkv projections
    # Per-layer sliding window pattern. window <= 0 means global attention.
    # ``local_window``/``global_every`` express gemma3's 5:1 local:global.
    local_window: int = 0             # 0 => all layers global
    global_every: int = 0             # every k-th layer is global (1-indexed)
    softcap: float = 0.0              # logit soft-capping (gemma-style), 0=off


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1) with
    q uncompressed: keys and values come from one normalised latent of
    ``kv_lora_rank`` a token, each head's key is ``qk_nope_head_dim`` wide
    from the latent plus one ``qk_rope_head_dim`` wide roped key shared by
    the heads; values ``v_head_dim`` wide.  YaRN rope (``rope_factor`` > 1)
    over ``original_max_position`` positions."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_factor: float = 1.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """The cache's width a token: the latent and the roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one SHARED attention block applied every `attn_every`
    # SSM layers (params reused across applications, paper-faithful to the
    # released model family).
    attn_every: int = 0
    # enc-dec (whisper): encoder depth & stubbed frontend frame count.
    n_enc_layers: int = 0
    n_frames: int = 1500              # encoder positions fed by the stub
    # vlm: number of stub patch-embedding positions prepended to the text.
    n_patches: int = 0
    # norm & misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"                 # silu | gelu
    glu: bool = True                  # gated MLP (SwiGLU/GeGLU) vs plain
    max_seq_len: int = 1 << 20
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # implementation switches (perf levers; see EXPERIMENTS §Perf)
    # "cuda" = the hand-written kernels (kernels/flash_attention.py,
    # kernels/flash_decode.py; kernels/ssd.py plus the inter-chunk
    # recurrence of kernels/ops.ssd); on a CPU or meta tensor it resolves to
    # their plain versions.  The kernels have no backward: training takes
    # "chunked" for both, the JAX package's defaults.  "pallas" is the JAX
    # package's TPU kernels and is not a value of the port.
    attention_impl: str = "cuda"      # cuda | chunked | reference
    ssm_impl: str = "cuda"            # cuda | chunked | reference
    attn_chunk: int = 1024            # KV chunk for streaming attention
    attn_causal_skip: bool = False    # skip above-diagonal kv blocks (§Perf)
    parallel_block: bool = False      # PaLM-style attn∥mlp (1 TP AR/layer)
    remat_group: int = 1              # layers per remat/scan group (§Perf)
    weight_quant: str = "none"        # none | int8 | int4 (weight-only, serving)
    cache_quant: str = "none"         # none | int8 (KV cache, serving)
    remat: str = "full"               # none | full | selective
    scan_layers: bool = True
    source: str = ""                  # provenance note [source; tier]
    # latent attention in place of ``attn``'s projections (``attn`` keeps
    # the heads, head_dim = the qk width, and the rope base); a dict is
    # taken as the MLAConfig's fields
    mla: Optional[MLAConfig] = None
    # the first ``n_dense_layers`` layers of an MoE stack have a dense MLP of
    # width ``d_ff`` (DeepSeek's ``first_k_dense_replace``)
    n_dense_layers: int = 0

    def __post_init__(self):
        if isinstance(self.mla, dict):
            object.__setattr__(self, "mla", MLAConfig(**self.mla))

    # ---- derived ----------------------------------------------------------
    @property
    def is_subquadratic(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        if self.attn is not None and self.attn.local_window > 0:
            return True                # sliding-window majority (gemma3)
        return False

    @property
    def has_decoder(self) -> bool:
        return True                    # all assigned archs decode (enc-dec incl.)

    def layer_windows(self) -> Tuple[int, ...]:
        """Static per-layer attention window (-1 == global) for the decoder."""
        a = self.attn
        if a is None:
            return tuple()
        out = []
        for i in range(self.n_layers):
            if a.local_window > 0 and a.global_every > 0:
                out.append(-1 if (i + 1) % a.global_every == 0 else a.local_window)
            else:
                out.append(-1)
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = v * d                                        # embed
        if not self.tie_embeddings:
            total += v * d                                   # lm head
        per_layer = 0
        if self.mla is not None:
            per_layer += _mla_params(self)
        elif self.attn is not None:
            a = self.attn
            qkv = d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim
            o = a.n_heads * a.head_dim * d
            per_layer += qkv + o
        mlp = (3 if self.glu else 2) * d               # a width's weights
        if self.family == "moe" and self.moe is not None:
            m = self.moe
            moe = m.n_experts * mlp * m.d_expert + d * m.n_experts
            # the shared experts: one MLP of d_ff each, or one of d_shared
            moe += mlp * (m.d_shared or m.n_shared_experts * f)
            # leading dense layers have an MLP of d_ff in its place
            nd = self.n_dense_layers
            total += nd * (mlp * f - moe)
            per_layer += moe
        elif self.family in ("ssm",):
            per_layer = _mamba2_params(self)
        elif self.family == "hybrid":
            per_layer = _mamba2_params(self)
        elif f > 0:
            per_layer += (3 if self.glu else 2) * d * f
        per_layer += 2 * d                                   # norms
        total += per_layer * self.n_layers
        if self.family == "hybrid" and self.attn is not None:
            a = self.attn
            total += (d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim
                      + a.n_heads * a.head_dim * d + d)      # one shared block
        if self.family == "encdec" and self.attn is not None:
            a = self.attn
            enc_layer = (d * a.n_heads * a.head_dim * 2
                         + 2 * d * a.n_kv_heads * a.head_dim
                         + (3 if self.glu else 2) * d * f + 2 * d)
            cross = (d * a.n_heads * a.head_dim * 2
                     + 2 * d * a.n_kv_heads * a.head_dim + d)
            total += enc_layer * self.n_enc_layers + cross * self.n_layers
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        L = self.n_layers - self.n_dense_layers
        e_mlp = (3 if self.glu else 2) * d * m.d_expert
        dense_total = self.param_count() - L * m.n_experts * e_mlp
        return dense_total + L * m.top_k * e_mlp


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


def shapes_for(cfg: ArchConfig) -> Sequence[ShapeConfig]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.is_subquadratic:
        out.append(SHAPES["long_500k"])
    return out


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# The port's fields that the JAX package's configs lack, at the values that
# keep the reference's behaviour.
PORT_ONLY_FIELDS = {
    "ArchConfig": {"mla": None, "n_dense_layers": 0},
    "MoEConfig": {"d_shared": 0, "norm_topk": True},
}


def config_dict(cfg: ArchConfig) -> Dict[str, Any]:
    """``dataclasses.asdict(cfg)`` without the port's own fields where they
    hold their defaults: for an architecture of both packages, the JAX
    package's dict, so the specs and artifact keys made from it are too."""
    d = dataclasses.asdict(cfg)
    for tree, name in ((d, "ArchConfig"), (d["moe"], "MoEConfig")):
        for key, default in PORT_ONLY_FIELDS[name].items():
            if tree is not None and tree[key] == default:
                del tree[key]
    return d


def _mla_params(cfg: ArchConfig) -> int:
    """One latent-attention block: q, the latent and roped key with the
    latent's norm, the latent's up projection to k_nope and v, and out."""
    m, h, d = cfg.mla, cfg.attn.n_heads, cfg.d_model
    return (d * h * m.qk_head_dim + d * m.latent_dim + m.kv_lora_rank
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            + h * m.v_head_dim * d)


def _mamba2_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    assert s is not None
    d = cfg.d_model
    d_inner = s.expand * d
    nh = d_inner // s.head_dim
    in_proj = d * (2 * d_inner + 2 * s.d_state + nh)   # z, x, B, C, dt
    conv = (d_inner + 2 * s.d_state) * s.d_conv
    out_proj = d_inner * d
    extra = nh * 2 + d_inner                           # A_log, D, gate norm
    return in_proj + conv + out_proj + extra


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            d_ff: int = 128, vocab: int = 256, seq: int = 32) -> ArchConfig:
    """Smoke-test-sized config of the same family (per assignment)."""
    changes = dict(
        n_layers=n_layers, d_model=d_model, vocab_size=vocab,
        d_ff=min(cfg.d_ff, d_ff) if cfg.d_ff else 0,
        param_dtype="float32", compute_dtype="float32",
        max_seq_len=max(seq * 4, 128),
    )
    if cfg.attn is not None:
        a = cfg.attn
        nh = max(2, min(4, a.n_heads))
        nkv = max(1, min(a.n_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        changes["attn"] = dataclasses.replace(
            a, n_heads=nh, n_kv_heads=nkv, head_dim=16,
            local_window=min(a.local_window, 16) if a.local_window else 0)
    if cfg.moe is not None:
        m = cfg.moe
        changes["moe"] = dataclasses.replace(
            m, n_experts=min(m.n_experts, 4), top_k=min(m.top_k, 2),
            d_expert=32, d_shared=32 * m.n_shared_experts if m.d_shared else 0)
    if cfg.mla is not None:              # head_dim 16 = 8 + 8, as the heads'
        changes["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=8, qk_rope_head_dim=8,
            v_head_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.n_enc_layers:
        changes["n_enc_layers"] = 2
        changes["n_frames"] = 16
    if cfg.n_patches:
        changes["n_patches"] = 4
    if cfg.attn_every:
        changes["attn_every"] = 2
    return dataclasses.replace(cfg, **changes)
