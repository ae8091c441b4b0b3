# Counterpart of src/repro/configs/llama4_scout_17b_a16e.py: the same data, nothing left unported.
"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,                    # shared-expert hidden width
    vocab_size=202048,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                    rope_theta=500000.0),
    moe=MoEConfig(n_experts=16, top_k=1, d_expert=8192, n_shared_experts=1,
                  capacity_factor=1.25),
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
