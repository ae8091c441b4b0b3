"""The benchmark's operation and byte counts against counts made by hand,
term by term, at small shapes."""
import math

import pytest

from portbench.reference import olmoe

OLMOE = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 4, "num_experts": 4,
         "num_experts_per_tok": 2, "intermediate_size": 6, "vocab_size": 10,
         "capacity_factor": 1.25}


def test_olmoe_prefill_flops_by_hand():
    # a layer, a token: q 2*8*(2*4), k and v 2*8*4 each, o 2*8*8, router
    # 2*8*4, two experts of three products 2*8*6 each
    per_token = 128 + 64 + 64 + 128 + 64 + 2 * 3 * 96
    # attention: QK and PV over the causal pairs of 3 tokens (6 pairs), 2
    # heads of 4: 2 * 2 * 2*4 a pair
    attn = 6 * 2 * 2 * 2 * 4
    head = 2 * 8 * 10                   # the last position's logits
    assert olmoe.prefill_flops(OLMOE, 3) == 2 * (3 * per_token + attn) + head


def test_olmoe_decode_flops_by_hand():
    per_token = 128 + 64 + 64 + 128 + 64 + 2 * 3 * 96
    keys = (5 + 1) + (9 + 1)            # rows at positions 5 and 9
    attn = keys * 2 * 2 * 2 * 4
    want = 2 * (2 * per_token + attn) + 2 * (2 * 8 * 10)
    assert olmoe.decode_flops(OLMOE, [5, 9]) == want


def test_k1_work_reads_the_prompt_once_and_counts_causal_pairs():
    n_bytes, flops = olmoe.k1_work(OLMOE, 3)
    # q and the output (3 tokens x 2 heads x 4), k and v (3 x 1 kv head x
    # 4), bf16; QK and PV over the 6 causal pairs, 2 heads of 4
    assert n_bytes == 2 * (2 * 3 * 2 * 4 + 2 * 3 * 1 * 4)
    assert flops == 6 * 2 * 2 * 2 * 4


def test_k2_work_reads_each_active_row_once():
    n_bytes, flops = olmoe.k2_work(OLMOE, [3, 7])
    # q read and output written (2 rows x 2 heads x 4), keys and values of
    # 10 cache rows x 1 kv head x 4, bf16; lengths int32
    assert n_bytes == 2 * (2 * 2 * 2 * 4 + 2 * 10 * 1 * 4) + 4 * 2
    assert flops == 4 * 2 * 4 * 10


@pytest.mark.parametrize("n,expected", [(1, 8), (64, 16), (100, 16),
                                        (1024, 160)])
def test_capacity_rounds_up_to_eight(n, expected):
    cfg = dict(OLMOE, num_experts=64, num_experts_per_tok=8)
    share = math.ceil(n * 8 / 64 * 1.25)
    assert olmoe.capacity(n, cfg) == expected == max(8, -(-share // 8) * 8)



@pytest.mark.parametrize("n", [1, 64, 100, 1024, 1536])
def test_capacity_is_the_programs_rule(n):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import capacity
    cfg = dict(OLMOE, num_experts=64, num_experts_per_tok=8)
    assert olmoe.capacity(n, cfg) == capacity(
        n, MoEConfig(n_experts=64, top_k=8, d_expert=6, capacity_factor=1.25))
