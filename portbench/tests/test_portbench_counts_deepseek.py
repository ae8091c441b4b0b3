"""The DeepSeek-V2 family's operation and byte counts against counts made by
hand, term by term, at small shapes."""
from portbench.reference import deepseek_v2 as ds

# d 8, 3 layers (the first dense), 2 heads, latent 4, qk 2 + 2 rope, v 3,
# 4 experts of 6 (top 2) and 2 shared (one MLP of 12), dense MLP 10, vocab 10
SMALL = {"hidden_size": 8, "num_hidden_layers": 3, "num_attention_heads": 2,
         "kv_lora_rank": 4, "qk_nope_head_dim": 2, "qk_rope_head_dim": 2,
         "v_head_dim": 3, "n_routed_experts": 4, "num_experts_per_tok": 2,
         "moe_intermediate_size": 6, "n_shared_experts": 2,
         "intermediate_size": 10, "first_k_dense_replace": 1,
         "vocab_size": 10, "rope_scaling": None}

# a layer, a token: q 2*8*2*(2+2), latent and roped key 2*8*(4+2), out
# 2*2*3*8
PROJ = 128 + 96 + 96
# the feed-forward of the three layers, a token: the dense layer's three
# products 3*2*8*10; each MoE layer's router 2*8*4, two experts of three
# products 2*3*2*8*6 and the shared MLP 3*2*8*12
FFN = 480 + 2 * (64 + 576 + 576)
HEAD = 2 * 8 * 10                       # one position's logits


def test_prefill_flops_by_hand():
    expand = 2 * 4 * 2 * (2 + 3)         # the latent to k_nope and v
    # QK at 2 + 2 and PV at 3 over the 6 causal pairs of 3 tokens, 2 heads
    attn = 6 * 2 * 2 * (4 + 3)
    want = 3 * (3 * (PROJ + expand) + FFN) + 3 * attn + HEAD
    assert ds.prefill_flops(SMALL, 3) == want


def test_decode_flops_by_hand():
    # q_nope into the latent 2*2*2*4 and the output out of it 2*2*4*3
    absorb = 32 + 48
    keys = (5 + 1) + (9 + 1)            # rows at positions 5 and 9
    # each head scores a key's latent and roped key (4 + 2) and sums its
    # latent (4)
    attn = keys * 2 * 2 * (4 + 2 + 4)
    want = 2 * (3 * (PROJ + absorb) + FFN + HEAD) + 3 * attn
    assert ds.decode_flops(SMALL, [5, 9]) == want


def test_k1_work_reads_the_prompt_once_and_counts_causal_pairs():
    n_bytes, flops = ds.k1_work(SMALL, 3)
    # q and k at 2 + 2 and v and the output at 3, 3 tokens x 2 heads, bf16
    assert n_bytes == 2 * 3 * 2 * (4 + 4 + 3 + 3)
    # QK at 4 and PV at 3 over the 6 causal pairs, 2 heads
    assert flops == 6 * 2 * 2 * (4 + 3)


def test_mla_decode_work_reads_each_active_rows_latents_once():
    n_bytes, flops = ds.mla_decode_work(SMALL, [3, 7])
    # 10 cache rows of 4 + 2, q (4 + 2) and the output (4) of 2 rows x 2
    # heads, bf16; the lengths int32
    assert n_bytes == 2 * (10 * 6 + 2 * 2 * (6 + 4)) + 4 * 2
    # each head: QK over 6 and PV over 4 for each of the 10 keys
    assert flops == 2 * 2 * 10 * (6 + 4)


def test_the_cells_latent_decode_bound_is_its_bytes():
    """At the cell's size the call is bound by reading the cache: 56 rows
    of about 17k keys of 1 152 bytes, about 0.33 ms at 3.35 TB/s."""
    from portbench.harness.program import bound_s
    import json
    from pathlib import Path
    c = json.loads((Path(ds.__file__).parents[1] / "configs" /
                    "deepseek-v2-lite.json").read_text())
    n_bytes, flops = ds.mla_decode_work(c, [17_000] * 56)
    assert n_bytes / 3.35e12 > flops / 989e12
    assert 0.32e-3 < bound_s(n_bytes, flops) < 0.34e-3


def test_the_latent_decode_roofline_reads_its_kernel_alone():
    """One call a layer a decode step in the slice, bounded by
    ``mla_decode_work``; a family without it, or a slice without the
    kernel, reads nothing."""
    import importlib.util
    from pathlib import Path
    from portbench.harness.program import bound_s
    from portbench.reference import olmoe
    path = Path(ds.__file__).parents[1] / "metrics" / \
        "kernels.mla_decode_roofline.py"
    spec = importlib.util.spec_from_file_location("mla_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    b = bound_s(*ds.mla_decode_work(SMALL, [6, 10]))
    kernels = [("rt::mla::mla_decode_kernel(...)", 2 * b),
               ("flash_attention_bf16_kernel", 1.0)] + \
        [("rt::mla::mla_decode_kernel(...)", 2 * b)] * 2
    run = {"family": ds, "config": SMALL,
           "slice_steps": [("prefill", None), ("decode", [5, 9])],
           "trace": {"kernels": kernels}}
    assert abs(mod.read(run) - 50.0) < 1e-9
    assert mod.read(dict(run, family=olmoe)) is None
    assert mod.read(dict(run, trace={"kernels": kernels[1:2]})) is None
