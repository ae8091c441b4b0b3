"""Plain reference of the DeepSeek-V2 family (arXiv:2405.04434) as the port
serves it, and what the benchmark needs to run a configuration of it: the
program's settings, the weights, and the operations a token needs.

The forward pass is float32 (TF32 off) or float8 products (``prec``), one
sequence at a time, layer by layer, each layer's weights cast on use, in the
published expanded form of latent attention (MLA), q uncompressed:

    q = h W_Q -> [H, dn + dr] = [q_nope | q_pe];  q_pe roped
    [c | k_pe] = h W_KVA;  c = RMSNorm(c);  k_pe roped (one for all heads)
    [k_nope | v]_h = c W_KVB[h];  k_h = [k_nope_h | k_pe]
    o_h = softmax(s q_h . k_h) v_h  (causal);  out = concat_h(o_h) W_O

with s = (dn + dr)^-1/2 times YaRN's mscale(factor, mscale_all_dim) squared,
and YaRN's rope over the pairs (2i, 2i + 1) of the dr roped widths.  The
attention runs in blocks of queries, so that 16k positions fit.  The layers'
feed-forward: the first ``first_k_dense_replace`` a SwiGLU of
``intermediate_size``; the rest a softmax router over the routed experts, the
top ``num_experts_per_tok`` with their softmax gates (not renormalised, times
``routed_scaling_factor``), each expert a SwiGLU of ``moe_intermediate_size``,
plus the shared experts as one SwiGLU of ``n_shared_experts`` times that
width.  The port's departure, which the configuration file lists: a prompt's
tokens past an expert's capacity (1.25 times an even share, padded to 8) are
dropped from it, in token order; a decode step routes one token a row and
drops none.

Weights are drawn from the seed on the device in one call, in the layout the
program takes (a nested dict, the leading dense layers stacked under
``dense_layers``, the MoE layers under ``layers``): ``initializer_range`` for
the embedding, 1/sqrt(fan-in) for the projections, ``router_logit_std`` /
sqrt(fan-in) for the router, and 1/sqrt(fan-in * 2 * layers) for the
projections that write to the residual stream.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.common import (draw_normal_leaves, mm, operand,
                                        rmsnorm, set_path)

KV_NORM_EPS = 1e-6
Q_BLOCK = 1024          # queries an attention block


def dims(c: dict) -> dict:
    r = c["rope_scaling"] or {}
    return dict(d=c["hidden_size"], L=c["num_hidden_layers"],
                H=c["num_attention_heads"], V=c["vocab_size"],
                r=c["kv_lora_rank"], dn=c["qk_nope_head_dim"],
                dr=c["qk_rope_head_dim"], dv=c["v_head_dim"],
                E=c["n_routed_experts"], k=c["num_experts_per_tok"],
                fe=c["moe_intermediate_size"],
                fs=c["moe_intermediate_size"] * c["n_shared_experts"],
                f=c["intermediate_size"], nd=c["first_k_dense_replace"],
                factor=float(r.get("factor", 1.0)))


def program_config(c: dict) -> dict:
    """The program's configuration (the fields of its ``ArchConfig``)."""
    m = dims(c)
    r = c["rope_scaling"] or {}
    return dict(
        family="moe", n_layers=m["L"], d_model=m["d"], d_ff=m["f"],
        vocab_size=m["V"],
        attn=dict(n_heads=m["H"], n_kv_heads=c["num_key_value_heads"],
                  head_dim=m["dn"] + m["dr"], rope_theta=c["rope_theta"]),
        mla=dict(kv_lora_rank=m["r"], qk_nope_head_dim=m["dn"],
                 qk_rope_head_dim=m["dr"], v_head_dim=m["dv"],
                 rope_factor=m["factor"],
                 original_max_position=r.get("original_max_position_embeddings",
                                             4096),
                 beta_fast=r.get("beta_fast", 32), beta_slow=r.get("beta_slow", 1),
                 mscale=r.get("mscale", 1.0),
                 mscale_all_dim=r.get("mscale_all_dim", 0.0)),
        moe=dict(n_experts=m["E"], top_k=m["k"], d_expert=m["fe"],
                 n_shared_experts=c["n_shared_experts"], d_shared=m["fs"],
                 norm_topk=c["norm_topk_prob"],
                 capacity_factor=c["capacity_factor"]),
        n_dense_layers=m["nd"], max_seq_len=c["max_position_embeddings"],
        norm_eps=c["rms_norm_eps"], tie_embeddings=c["tie_word_embeddings"],
        act=c["hidden_act"], glu=True, param_dtype=c["dtype"],
        compute_dtype=c["dtype"])


def init_params(c: dict, gen: torch.Generator, device, dtype) -> dict:
    m = dims(c)
    d, L, H, V, E = m["d"], m["L"], m["H"], m["V"], m["E"]
    r, dn, dr, dv, fe, fs, f, nd = (m[x] for x in
                                    ("r", "dn", "dr", "dv", "fe", "fs", "f", "nd"))
    out_std = 1.0 / math.sqrt(2 * L)
    normal = [("embed.embedding", (V, d), c["initializer_range"])]
    for stack, n in (("dense_layers", nd), ("layers", L - nd)):
        if not n:
            continue
        normal += [
            (f"{stack}.attn.wq.kernel", (n, d, H, dn + dr), d ** -0.5),
            (f"{stack}.attn.wkv_a.kernel", (n, d, r + dr), d ** -0.5),
            (f"{stack}.attn.wkv_b.kernel", (n, r, H, dn + dv), r ** -0.5),
            (f"{stack}.attn.wo.kernel", (n, H, dv, d),
             (H * dv) ** -0.5 * out_std)]
        if stack == "dense_layers":
            normal += [
                (f"{stack}.mlp.wi.kernel", (n, d, f), d ** -0.5),
                (f"{stack}.mlp.wg.kernel", (n, d, f), d ** -0.5),
                (f"{stack}.mlp.wo.kernel", (n, f, d), f ** -0.5 * out_std)]
            continue
        normal += [
            (f"{stack}.moe.router.kernel", (n, d, E),
             c["router_logit_std"] * d ** -0.5),
            (f"{stack}.moe.wi", (n, E, d, fe), d ** -0.5),
            (f"{stack}.moe.wg", (n, E, d, fe), d ** -0.5),
            (f"{stack}.moe.wo", (n, E, fe, d), fe ** -0.5 * out_std),
            (f"{stack}.moe.shared.wi.kernel", (n, d, fs), d ** -0.5),
            (f"{stack}.moe.shared.wg.kernel", (n, d, fs), d ** -0.5),
            (f"{stack}.moe.shared.wo.kernel", (n, fs, d),
             fs ** -0.5 * out_std)]
    if not c["tie_word_embeddings"]:
        normal.append(("lm_head.kernel", (d, V), d ** -0.5))
    params: Dict = {}
    views = draw_normal_leaves([(s, std) for _, s, std in normal], gen,
                               device, dtype)
    for (path, _, _), t in zip(normal, views):
        set_path(params, path, t)
    ones = [("final_norm.scale", (d,))]
    for stack, n in (("dense_layers", nd), ("layers", L - nd)):
        if n:
            ones += [(f"{stack}.attn_norm.scale", (n, d)),
                     (f"{stack}.mlp_norm.scale", (n, d)),
                     (f"{stack}.attn.kv_norm.scale", (n, r))]
    for path, shape in ones:
        set_path(params, path, torch.ones(shape, device=device, dtype=dtype))
    return params


# ---------------------------------------------------------------------------
# YaRN rope and the softmax scale
# ---------------------------------------------------------------------------

def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(c: dict):
    """(low, high) of YaRN's ramp over the rope pairs."""
    r, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]

    def corr(n_rot: float) -> float:
        return (dim * math.log(r["original_max_position_embeddings"]
                               / (n_rot * 2 * math.pi)) / (2 * math.log(base)))
    return (max(math.floor(corr(r["beta_fast"])), 0),
            min(math.ceil(corr(r["beta_slow"])), dim - 1))


def inv_freq(c: dict, device) -> torch.Tensor:
    dim, base = c["qk_rope_head_dim"], c["rope_theta"]
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim)
    r = c["rope_scaling"]
    if not r or r["factor"] <= 1:
        return extra
    low, high = yarn_range(c)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    return extra / r["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(c: dict) -> float:
    s = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    r = c["rope_scaling"]
    if r and r.get("mscale_all_dim"):
        s *= yarn_get_mscale(r["factor"], r["mscale_all_dim"]) ** 2
    return s


def rope_pairs(x: torch.Tensor, c: dict) -> torch.Tensor:
    """YaRN rope of ``x`` [T, ..., dr] at positions 0..T-1, the pairs
    (2i, 2i + 1) rotated by angle i (interleaved, as published)."""
    t = x.shape[0]
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * \
        inv_freq(c, x.device)
    r = c["rope_scaling"] or {}
    k = (yarn_get_mscale(r.get("factor", 1.0), r.get("mscale", 1.0))
         / yarn_get_mscale(r.get("factor", 1.0), r.get("mscale_all_dim", 0.0)))
    shape = (t,) + (1,) * (x.ndim - 2) + (-1,)
    cos, sin = (torch.cos(ang) * k).view(shape), (torch.sin(ang) * k).view(shape)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin],
                       dim=-1).flatten(-2)


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------

def _attention(a: dict, c: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Latent attention over ``h`` [T, d], expanded, causal, in blocks of
    ``Q_BLOCK`` queries."""
    m = dims(c)
    t, H, dn, dr, dv, r = h.shape[0], m["H"], m["dn"], m["dr"], m["dv"], m["r"]
    q = mm(h, a["wq"]["kernel"].float().flatten(1), prec).view(t, H, dn + dr)
    q = torch.cat([q[..., :dn], rope_pairs(q[..., dn:], c)], dim=-1)
    kv = mm(h, a["wkv_a"]["kernel"].float(), prec)
    lat = rmsnorm(kv[:, :r], a["kv_norm"]["scale"].float(), KV_NORM_EPS)
    k_pe = rope_pairs(kv[:, r:], c)
    kvb = mm(lat, a["wkv_b"]["kernel"].float().flatten(1), prec).view(
        t, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(t, H, dr)], dim=-1)
    v = kvb[..., dn:]
    qo, ko, vo = (operand(x, prec) for x in (q, k, v))
    s = softmax_scale(c)
    out = torch.empty(t, H, dv, device=h.device)
    for lo in range(0, t, Q_BLOCK):
        hi = min(t, lo + Q_BLOCK)
        sc = torch.einsum("thd,shd->hts", qo[lo:hi], ko[:hi]) * s
        mask = (torch.arange(lo, hi, device=h.device)[:, None]
                >= torch.arange(hi, device=h.device)[None])
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[lo:hi] = torch.einsum("hts,shd->thd", operand(p, prec), vo[:hi])
    return mm(out.flatten(1), a["wo"]["kernel"].float().flatten(0, 1), prec)


def _swiglu(p: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    a = torch.nn.functional.silu(mm(h, p["wi"]["kernel"].float(), prec))
    a = a * mm(h, p["wg"]["kernel"].float(), prec)
    return mm(a, p["wo"]["kernel"].float(), prec)


def capacity(n_tokens: int, c: dict) -> int:
    """An expert's slots for a sequence of ``n_tokens``: ``capacity_factor``
    times an even share, rounded up to a multiple of 8 (at least 8)."""
    m = dims(c)
    share = math.ceil(n_tokens * m["k"] / m["E"] * c["capacity_factor"])
    return max(8, -(-share // 8) * 8)


def _moe(p: dict, c: dict, h: torch.Tensor, prompt_len: int, prec: str):
    """The MoE layer over ``h`` [T, d]: positions below ``prompt_len`` were
    one prefill (dropped past capacity), the rest one token a decode step;
    the shared experts added for every token."""
    m = dims(c)
    probs = torch.softmax(mm(h, p["router"]["kernel"].float(), prec), dim=-1)
    g, e = torch.topk(probs, m["k"], dim=-1, sorted=True)
    if c["norm_topk_prob"]:
        g = g / g.sum(-1, keepdim=True)
    g = g * c["routed_scaling_factor"]
    keep = torch.ones_like(e, dtype=torch.bool)
    if prompt_len:
        ep = e[:prompt_len]
        chosen = torch.zeros(prompt_len, m["E"], device=h.device)
        chosen.scatter_(1, ep, 1.0)
        earlier = torch.cumsum(chosen, 0) - chosen     # earlier tokens, same expert
        keep[:prompt_len] = earlier.gather(1, ep) < capacity(prompt_len, c)
    y = _swiglu(p["shared"], h, prec)
    for x in range(m["E"]):
        t, j = torch.nonzero((e == x) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        hx = h[t]
        a = torch.nn.functional.silu(mm(hx, p["wi"][x].float(), prec))
        a = a * mm(hx, p["wg"][x].float(), prec)
        y.index_add_(0, t, mm(a, p["wo"][x].float(), prec) * g[t, j, None])
    return y


def _layers(params: dict, c: dict):
    """Each layer's parameters, the leading dense layers first."""
    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    m = dims(c)
    out = [pick(params["dense_layers"], i) for i in range(m["nd"])]
    return out + [pick(params["layers"], i) for i in range(m["L"] - m["nd"])]


@torch.no_grad()
def forward(params: dict, c: dict, tokens: torch.Tensor, prompt_len: int,
            prec: str = "f32") -> torch.Tensor:
    """Logits [T, V] float32 of one sequence ``tokens`` [T]: a prompt of
    ``prompt_len`` tokens, then the tokens fed back one decode step each."""
    eps = c["rms_norm_eps"]
    x = params["embed"]["embedding"][tokens.long()].float()
    for p in _layers(params, c):
        h = rmsnorm(x, p["attn_norm"]["scale"].float(), eps)
        x = x + _attention(p["attn"], c, h, prec)
        h = rmsnorm(x, p["mlp_norm"]["scale"].float(), eps)
        x = x + (_moe(p["moe"], c, h, prompt_len, prec) if "moe" in p
                 else _swiglu(p["mlp"], h, prec))
    x = rmsnorm(x, params["final_norm"]["scale"].float(), eps)
    head = (params["embed"]["embedding"].float().T
            if c["tie_word_embeddings"] else params["lm_head"]["kernel"].float())
    return mm(x, head, prec)


# ---------------------------------------------------------------------------
# Operations the inputs need (multiply-add = 2), in the published inference
# form: the prefill expanded (k_nope and v made for every token and head),
# a decode step absorbed (q_nope taken into the latent and the output out of
# it, each head scoring the cache's latent and roped key)
# ---------------------------------------------------------------------------

def _ffn_flops_per_token(c: dict) -> float:
    """The feed-forward of every layer, one token."""
    m = dims(c)
    d = m["d"]
    moe = 2.0 * d * m["E"] + m["k"] * 6.0 * d * m["fe"] + 6.0 * d * m["fs"]
    return m["nd"] * 6.0 * d * m["f"] + (m["L"] - m["nd"]) * moe


def _proj_flops_per_token(c: dict) -> float:
    """One layer's projections that every form makes, one token: q, the
    latent and roped key, the output."""
    m = dims(c)
    d, H = m["d"], m["H"]
    return (2.0 * d * H * (m["dn"] + m["dr"]) + 2.0 * d * (m["r"] + m["dr"])
            + 2.0 * H * m["dv"] * d)


def prefill_flops(c: dict, n: int) -> float:
    """A prefill of ``n`` tokens: every layer at every position, the latent
    expanded to k_nope and v, attention over the causal pairs (scores at qk
    dn + dr, values at dv), and the logits of the last position."""
    m = dims(c)
    expand = 2.0 * m["r"] * m["H"] * (m["dn"] + m["dv"])
    pairs = n * (n + 1) // 2
    attn = 2.0 * m["H"] * (m["dn"] + m["dr"] + m["dv"]) * pairs
    return (n * (m["L"] * (_proj_flops_per_token(c) + expand)
                 + _ffn_flops_per_token(c))
            + m["L"] * attn + 2.0 * m["d"] * m["V"])


def decode_flops(c: dict, positions: List[int]) -> float:
    """One decode step of the rows at ``positions`` (each reads its position
    plus one keys), absorbed: q_nope into the latent and the output out of
    it, the heads scoring the keys' latent and roped key and summing their
    latents; with the rows' logits."""
    m = dims(c)
    rows = len(positions)
    absorb = 2.0 * m["H"] * m["dn"] * m["r"] + 2.0 * m["H"] * m["r"] * m["dv"]
    keys = sum(p + 1 for p in positions)
    return (rows * (m["L"] * (_proj_flops_per_token(c) + absorb)
                    + _ffn_flops_per_token(c) + 2.0 * m["d"] * m["V"])
            + m["L"] * 2.0 * m["H"] * keys * (2 * m["r"] + m["dr"]))


def k1_work(c: dict, n: int, elt: int = 2):
    """(bytes, operations) of one layer's flash-attention call over a
    prefill of ``n`` tokens: q and k (dn + dr a head) and v (dv) read once,
    the output (dv) written once; the causal pairs' products."""
    m = dims(c)
    qk, dv, H = m["dn"] + m["dr"], m["dv"], m["H"]
    n_bytes = elt * n * H * (2 * qk + 2 * dv)
    return n_bytes, 2.0 * H * (qk + dv) * (n * (n + 1) // 2)


def mla_decode_work(c: dict, keys_per_row: List[int], elt: int = 2):
    """(bytes, operations) of one layer's latent-decode call over the rows
    that need it: each row's cache keys (r + dr) read once, q (r + dr a
    head) read and the output (r a head) written, the lengths read; each
    head scores every key (r + dr) and sums its latent (r)."""
    m = dims(c)
    rows, keys = len(keys_per_row), sum(keys_per_row)
    w, H = m["r"] + m["dr"], m["H"]
    n_bytes = elt * (keys * w + rows * H * (w + m["r"])) + 4 * rows
    return n_bytes, 2.0 * H * keys * (w + m["r"])
