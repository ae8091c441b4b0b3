# Counterpart of src/repro/configs/qwen2_5_14b.py: the same data, nothing left unported.
"""qwen2.5-14b — dense GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab_size=152064,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128, qkv_bias=True,
                    rope_theta=1000000.0),
    norm_eps=1e-5,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)
