"""Plain reference of the OLMoE family as the port serves it, and what the
benchmark needs to run a configuration of it: the program's settings, the
weights, and the operations a token needs.

The forward pass is float32 (TF32 off) or float8 products (``prec``), one
sequence at a time, layer by layer, each layer's weights cast on use.  It
follows arXiv:2409.02060 with the port's departures, which the configuration
file lists: the gates of the top 8 are renormalised, q and k are
RMS-normalised per head (eps 1e-6), and a prompt's tokens are dropped from an
expert past its capacity (1.25 times an even share, padded to 8), in token
order; a decode step routes one token a row and drops none.

Weights are drawn from the seed on the device in one call, in the layout the
program takes (a nested dict, layers stacked on the first axis):
``std`` ``initializer_range`` for the embedding, 1/sqrt(fan-in) for the
projections, ``router_logit_std``/sqrt(fan-in) for the router, and
1/sqrt(fan-in * 2 * layers) for the two projections that write to the
residual stream (attention's output, the experts' second product).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.common import (causal_attention, draw_normal_leaves,
                                        mm, rmsnorm, rope, set_path)

QK_NORM_EPS = 1e-6


def dims(c: dict) -> dict:
    d = c["hidden_size"]
    return dict(d=d, L=c["num_hidden_layers"], H=c["num_attention_heads"],
                KV=c["num_key_value_heads"], hd=c["head_dim"],
                E=c["num_experts"], k=c["num_experts_per_tok"],
                fe=c["intermediate_size"], V=c["vocab_size"])


def program_config(c: dict) -> dict:
    """The program's configuration (the fields of its ``ArchConfig``)."""
    return dict(
        family="moe", n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        attn=dict(n_heads=c["num_attention_heads"],
                  n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
                  qk_norm=True, rope_theta=c["rope_theta"]),
        moe=dict(n_experts=c["num_experts"], top_k=c["num_experts_per_tok"],
                 d_expert=c["intermediate_size"],
                 capacity_factor=c["capacity_factor"],
                 aux_loss_coef=c["router_aux_loss_coef"]),
        norm_eps=c["rms_norm_eps"], tie_embeddings=c["tie_word_embeddings"],
        act=c["hidden_act"], glu=True, param_dtype=c["dtype"],
        compute_dtype=c["dtype"])


def init_params(c: dict, gen: torch.Generator, device, dtype) -> dict:
    m = dims(c)
    d, L, H, KV, hd, E, fe, V = (m[x] for x in
                                 ("d", "L", "H", "KV", "hd", "E", "fe", "V"))
    out_std = 1.0 / math.sqrt(2 * L)
    normal = [
        ("embed.embedding", (V, d), c["initializer_range"]),
        ("layers.attn.wq.kernel", (L, d, H, hd), d ** -0.5),
        ("layers.attn.wk.kernel", (L, d, KV, hd), d ** -0.5),
        ("layers.attn.wv.kernel", (L, d, KV, hd), d ** -0.5),
        ("layers.attn.wo.kernel", (L, H, hd, d), (H * hd) ** -0.5 * out_std),
        ("layers.moe.router.kernel", (L, d, E),
         c["router_logit_std"] * d ** -0.5),
        ("layers.moe.wi", (L, E, d, fe), d ** -0.5),
        ("layers.moe.wg", (L, E, d, fe), d ** -0.5),
        ("layers.moe.wo", (L, E, fe, d), fe ** -0.5 * out_std),
    ]
    if not c["tie_word_embeddings"]:
        normal.append(("lm_head.kernel", (d, V), d ** -0.5))
    params: Dict = {}
    views = draw_normal_leaves([(s, std) for _, s, std in normal], gen,
                               device, dtype)
    for (path, _, _), t in zip(normal, views):
        set_path(params, path, t)
    for path, shape in (("final_norm.scale", (d,)),
                        ("layers.attn_norm.scale", (L, d)),
                        ("layers.mlp_norm.scale", (L, d)),
                        ("layers.attn.q_norm.scale", (L, hd)),
                        ("layers.attn.k_norm.scale", (L, hd))):
        set_path(params, path, torch.ones(shape, device=device, dtype=dtype))
    return params


def capacity(n_tokens: int, c: dict) -> int:
    """An expert's slots for a sequence of ``n_tokens``: ``capacity_factor``
    times an even share, rounded up to a multiple of 8 (at least 8)."""
    m = dims(c)
    share = math.ceil(n_tokens * m["k"] / m["E"] * c["capacity_factor"])
    return max(8, -(-share // 8) * 8)


def _moe(p: dict, c: dict, h: torch.Tensor, prompt_len: int, prec: str):
    """The MoE layer over ``h`` [T, d]: positions below ``prompt_len`` were
    one prefill (dropped past capacity), the rest one token a decode step."""
    m = dims(c)
    probs = torch.softmax(mm(h, p["router"]["kernel"].float(), prec), dim=-1)
    g, e = torch.topk(probs, m["k"], dim=-1, sorted=True)
    g = g / g.sum(-1, keepdim=True)
    keep = torch.ones_like(e, dtype=torch.bool)
    if prompt_len:
        ep = e[:prompt_len]
        chosen = torch.zeros(prompt_len, m["E"], device=h.device)
        chosen.scatter_(1, ep, 1.0)
        earlier = torch.cumsum(chosen, 0) - chosen     # earlier tokens, same expert
        keep[:prompt_len] = earlier.gather(1, ep) < capacity(prompt_len, c)
    y = torch.zeros_like(h)
    for x in range(m["E"]):
        t, j = torch.nonzero((e == x) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        hx = h[t]
        a = torch.nn.functional.silu(mm(hx, p["wi"][x].float(), prec))
        a = a * mm(hx, p["wg"][x].float(), prec)
        y.index_add_(0, t, mm(a, p["wo"][x].float(), prec) * g[t, j, None])
    return y


def _layer(params: dict, i: int) -> dict:
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(params["layers"])


@torch.no_grad()
def forward(params: dict, c: dict, tokens: torch.Tensor, prompt_len: int,
            prec: str = "f32") -> torch.Tensor:
    """Logits [T, V] float32 of one sequence ``tokens`` [T]: a prompt of
    ``prompt_len`` tokens, then the tokens fed back one decode step each."""
    m = dims(c)
    t = tokens.shape[0]
    eps = c["rms_norm_eps"]
    x = params["embed"]["embedding"][tokens.long()].float()
    for i in range(m["L"]):
        p = _layer(params, i)
        a = p["attn"]
        h = rmsnorm(x, p["attn_norm"]["scale"].float(), eps)
        q, k, v = (mm(h, a[w]["kernel"].float().flatten(1), prec)
                   .view(t, -1, m["hd"]) for w in ("wq", "wk", "wv"))
        q = rope(rmsnorm(q, a["q_norm"]["scale"].float(), QK_NORM_EPS),
                 c["rope_theta"])
        k = rope(rmsnorm(k, a["k_norm"]["scale"].float(), QK_NORM_EPS),
                 c["rope_theta"])
        ctx = causal_attention(q, k, v, prec)
        x = x + mm(ctx.flatten(1), a["wo"]["kernel"].float().flatten(0, 1),
                   prec)
        h = rmsnorm(x, p["mlp_norm"]["scale"].float(), eps)
        x = x + _moe(p["moe"], c, h, prompt_len, prec)
    x = rmsnorm(x, params["final_norm"]["scale"].float(), eps)
    head = (params["embed"]["embedding"].float().T
            if c["tie_word_embeddings"] else params["lm_head"]["kernel"].float())
    return mm(x, head, prec)


# ---------------------------------------------------------------------------
# Operations the inputs need (multiply-add = 2)
# ---------------------------------------------------------------------------

def _layer_flops_per_token(c: dict) -> float:
    m = dims(c)
    d, H, KV, hd = m["d"], m["H"], m["KV"], m["hd"]
    return (2.0 * d * (H + 2 * KV) * hd + 2.0 * H * hd * d
            + 2.0 * d * m["E"] + m["k"] * 6.0 * d * m["fe"])


def attention_flops(c: dict, keys: int) -> float:
    """One query head group's QK^T and PV over ``keys`` keys, all heads."""
    m = dims(c)
    return 4.0 * m["H"] * m["hd"] * keys


def prefill_flops(c: dict, n: int) -> float:
    """A prefill of ``n`` tokens: every layer at every position, causal
    pairs only, and the logits of the last position."""
    m = dims(c)
    return (m["L"] * (n * _layer_flops_per_token(c)
                      + attention_flops(c, n * (n + 1) // 2))
            + 2.0 * m["d"] * m["V"])


def decode_flops(c: dict, positions: List[int]) -> float:
    """One decode step of the rows at ``positions`` (each attends its
    position plus one keys), with their logits."""
    m = dims(c)
    keys = sum(p + 1 for p in positions)
    return (m["L"] * (len(positions) * _layer_flops_per_token(c)
                      + attention_flops(c, keys))
            + 2.0 * m["d"] * m["V"] * len(positions))


def k1_work(c: dict, n: int, elt: int = 2):
    """(bytes, operations) of one layer's flash-attention call over a
    prefill of ``n`` tokens: q, k and v read once, the output written once,
    the causal pairs' products."""
    m = dims(c)
    n_bytes = elt * n * m["hd"] * (2 * m["H"] + 2 * m["KV"])
    return n_bytes, attention_flops(c, n * (n + 1) // 2)


def k2_work(c: dict, keys_per_row: List[int], elt: int = 2):
    """(bytes, operations) of one layer's flash-decode call over the rows
    that need it: q read, each row's cache keys and values read once, the
    output written, the lengths read."""
    m = dims(c)
    rows, keys = len(keys_per_row), sum(keys_per_row)
    n_bytes = (elt * (2 * rows * m["H"] * m["hd"] + 2 * keys * m["KV"] * m["hd"])
               + 4 * rows)
    return n_bytes, attention_flops(c, keys)
