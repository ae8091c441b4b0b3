"""DeepSeek-V2-Lite in the port (latent attention, shared experts, a leading
dense layer) against the benchmark's plain reference
(``portbench/reference/deepseek_v2.py``, plain torch), on the CPU at a small
size with seeded random weights, in float32: the kernels' plain versions run,
so the two differ by the order of their sums alone (limits 1e-4 of the
largest logit, or 1e-5 where one layer is compared).  The published sizes are
held to the formulas of the configuration (YaRN's ramp, the softmax scale,
the parameter count)."""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import deepseek_v2 as REF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

PUBLISHED = json.loads((ROOT / "portbench" / "configs" /
                        "deepseek-v2-lite.json").read_text())
SMALL = dict(PUBLISHED, hidden_size=64, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
             intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, num_experts_per_tok=2, vocab_size=256,
             dtype="float32")


def program(c: dict, **over) -> ArchConfig:
    kw = REF.program_config(c)
    kw["attn"] = AttnConfig(**kw["attn"])
    kw["moe"] = MoEConfig(**kw["moe"])
    kw.update(over)
    return ArchConfig(name="deepseek-v2-lite-small", **kw)


@pytest.fixture(scope="module")
def small():
    cfg = program(SMALL, attention_impl="cuda")      # plain versions here
    gen = torch.Generator().manual_seed(29)
    params = REF.init_params(SMALL, gen, "cpu", torch.float32)
    return cfg, params


def test_the_registry_config_is_the_files():
    cfg = get_config("deepseek-v2-lite")
    want = program(PUBLISHED)
    for f in ("n_layers", "d_model", "d_ff", "vocab_size", "attn", "mla",
              "moe", "n_dense_layers", "norm_eps", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(want, f), f


def test_the_published_count_of_parameters():
    """15.7 B: 15 706 484 224 with the final norm left out, as
    `param_count` leaves it (the latent's 27 norms of 512 in)."""
    cfg = get_config("deepseek-v2-lite")
    assert cfg.param_count() == 15_706_484_224 - 2048
    specs = build_model(cfg, device="meta").specs()
    n = sum(math.prod(s.shape) for s in L.tree_leaves(
        L.map_specs(lambda s: s, specs)))
    assert n == cfg.param_count() + 2048          # the final norm


def test_yarn_tables_are_the_formulas_at_the_published_sizes():
    cfg = get_config("deepseek-v2-lite")
    m = cfg.mla
    assert MLA.yarn_correction_range(m, 10000.0) == (10, 23)
    i = torch.arange(32, dtype=torch.float64)
    f_extra = 10000.0 ** (-2 * i / 64)
    ramp = ((i - 10) / (23 - 10)).clamp(0, 1)
    want = f_extra / 40 * ramp + f_extra * (1 - ramp)
    got = MLA.yarn_inv_freq(m, 10000.0).double()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert abs(mscale - 1.26080) < 1e-5
    assert abs(MLA.softmax_scale(cfg) - 192 ** -0.5 * mscale ** 2) < 1e-12
    assert abs(MLA.softmax_scale(cfg) - 0.114721) < 1e-6
    # cos and sin are scaled by mscale / mscale_all_dim = 1
    cos, sin = MLA.rope_tables(cfg, torch.tensor([[5]]))
    torch.testing.assert_close(cos ** 2 + sin ** 2,
                               torch.ones_like(cos), rtol=1e-6, atol=1e-6)
    # the reference's tables are the same
    assert REF.yarn_range(PUBLISHED) == (10, 23)
    torch.testing.assert_close(REF.inv_freq(PUBLISHED, "cpu"),
                               MLA.yarn_inv_freq(m, 10000.0))


def test_rope_rotates_interleaved_pairs():
    cfg = get_config("deepseek-v2-lite")
    x = torch.randn(1, 3, 2, 64, generator=torch.Generator().manual_seed(1))
    tables = MLA.rope_tables(cfg, torch.arange(3)[None])
    got = MLA.apply_rope_pairs(x, tables)
    torch.testing.assert_close(got, REF.rope_pairs(x[0], PUBLISHED)[None])
    ang = 2 * MLA.yarn_inv_freq(cfg.mla, 10000.0)[7]     # position 2, pair 7
    a, b = x[0, 2, 1, 14], x[0, 2, 1, 15]
    torch.testing.assert_close(got[0, 2, 1, 14:16], torch.stack(
        [a * torch.cos(ang) - b * torch.sin(ang),
         b * torch.cos(ang) + a * torch.sin(ang)]))


def test_gates_are_not_renormalised_and_the_shared_experts_are_one_mlp():
    cfg = get_config("deepseek-v2-lite")
    assert cfg.moe.norm_topk is False and cfg.moe.top_k == 6
    shared = M.moe_specs(cfg)["shared"]
    assert shared["wi"]["kernel"].shape == (2048, 2 * 1408)
    assert shared["wo"]["kernel"].shape == (2 * 1408, 2048)
    small = program(SMALL)
    gen = torch.Generator().manual_seed(3)
    router = {"kernel": torch.randn(64, 8, generator=gen)}
    x = torch.randn(2, 5, 64, generator=gen)
    top_e, top_g, _ = M.route(router, x, small.moe)
    probs = torch.softmax(x @ router["kernel"], dim=-1)
    torch.testing.assert_close(top_g, probs.gather(-1, top_e))
    assert (top_g.sum(-1) < 1).all()
    renorm = dataclasses.replace(small.moe, norm_topk=True)
    _, g2, _ = M.route(router, x, renorm)
    torch.testing.assert_close(g2.sum(-1), torch.ones(2, 5))


def test_the_dense_layer_and_the_moe_layers_agree_with_the_reference(small):
    cfg, params = small
    layers = T.split_layers(params, cfg)
    assert len(layers) == 3 and "mlp" in layers[0] and "moe" in layers[1]
    gen = torch.Generator().manual_seed(5)
    h = torch.randn(1, 12, 64, generator=gen)
    got = L.mlp(layers[0]["mlp"], h, cfg.act, torch.float32)
    want = REF._swiglu(layers[0]["mlp"], h[0], "f32")
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)
    for p in layers[1:]:
        got, aux = M.moe_mlp(p["moe"], cfg, h)
        want = REF._moe(p["moe"], SMALL, h[0], 12, "f32")
        torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)


def test_the_absorbed_decode_equals_the_expanded_attention(small):
    """The last position's attention over a prompt's latents: the decode
    step's absorbed form (over the cache) against the prefill's expanded
    form (over the sequence)."""
    cfg, params = small
    p = T.split_layers(params, cfg)[1]["attn"]
    gen = torch.Generator().manual_seed(7)
    s = 9
    h = torch.randn(2, s, 64, generator=gen)
    pos = torch.arange(s)[None].expand(2, s)
    q_nope, q_pe, latent = MLA.project(p, cfg, h, T.rope_tables(cfg, pos),
                                       torch.float32)
    expanded = MLA.attend_expanded(p, cfg, q_nope, q_pe, latent,
                                   torch.float32)[:, -1]
    cache = torch.zeros(2, 16, latent.shape[-1])
    cache[:, :s] = latent
    lengths = torch.full((2,), s, dtype=torch.int32)
    absorbed = MLA.attend_absorbed(p, cfg, q_nope[:, -1:], q_pe[:, -1:],
                                   cache, lengths, torch.float32)[:, 0]
    torch.testing.assert_close(absorbed, expanded, rtol=1e-5, atol=1e-5)


def test_the_decode_takes_the_kernel_on_cuda_and_the_plain_version_else():
    """As a decode step's other attention: ``attention_impl`` "cuda" is the
    latent-decode kernel's wrapper (its plain version off the card), the
    plain paths take the plain version, so a plain model on the card runs
    no kernel."""
    from repro_torch.kernels import mla_decode as MD
    assert MLA.decode_attend("cuda") is MD.mla_decode
    for impl in ("reference", "chunked"):
        assert MLA.decode_attend(impl) is MD.mla_decode_plain
    with pytest.raises(ValueError):
        MLA.decode_attend("pallas")


@pytest.mark.parametrize("impl", ["cuda", "chunked", "reference"])
def test_prefill_then_decode_through_the_latent_cache_gives_the_references_logits(
        small, impl):
    cfg, params = small
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(11)
    b, n, steps = 2, 10, 4
    tokens = torch.randint(0, 256, (b, n), generator=gen)
    cache = model.init_cache(b, 32)
    assert cache["latent"].shape == (3, b, 32, 32 + 16)
    logits, cache, _ = model.prefill(params, {"tokens": tokens}, cache)
    seqs, got = tokens, [logits[:, 0]]
    for _ in range(steps):
        tok = got[-1].argmax(-1, keepdim=True).int()
        seqs = torch.cat([seqs, tok.long()], dim=1)
        logits, cache, _ = model.decode_step(params, tok, cache)
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)                        # [b, steps + 1, V]
    for row in range(b):
        want = REF.forward(params, SMALL, seqs[row, :-1], n, "f32")[n - 1:]
        scale = want.abs().max()
        assert (got[row, :want.shape[0]] - want).abs().max() < 1e-4 * scale


def test_a_layers_latent_is_cached_as_the_published_576(small):
    cfg = get_config("deepseek-v2-lite")
    model = build_model(cfg, device="meta")
    cache = model.init_cache(2, 8)
    assert set(cache) == {"length", "latent"}
    assert cache["latent"].shape == (27, 2, 8, 576)
    assert cfg.mla.latent_dim * 2 * 27 == 31_104        # bytes a token
