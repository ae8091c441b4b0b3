# Counterpart of src/repro/configs/qwen3_1_7b.py: the same data, nothing left unported.
"""qwen3-1.7b — dense GQA with qk-norm.  [hf:Qwen/Qwen3-8B; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    d_ff=6144,
    vocab_size=151936,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=128, qk_norm=True,
                    rope_theta=1000000.0),
    tie_embeddings=True,
    norm_eps=1e-6,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
