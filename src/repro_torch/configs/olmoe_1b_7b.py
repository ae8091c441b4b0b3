# Counterpart of src/repro/configs/olmoe_1b_7b.py: the same data, nothing left unported.
"""olmoe-1b-7b — 64-expert top-8 MoE.  [arXiv:2409.02060; hf]
16L d_model=2048 16H (GQA kv=16) d_expert=1024 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    d_ff=1024,
    vocab_size=50304,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                    qk_norm=True, rope_theta=10000.0),
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024, n_shared_experts=0,
                  capacity_factor=1.25),
    norm_eps=1e-5,
    source="[arXiv:2409.02060; hf]",
)
