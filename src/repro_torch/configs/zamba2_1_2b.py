# Counterpart of src/repro/configs/zamba2_1_2b.py: the same data, nothing left unported.
"""zamba2-1.2b — hybrid: Mamba2 backbone + one SHARED attention block applied
every 6 layers (params reused).  [arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_size=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=64),
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, d_conv=4, chunk=256),
    attn_every=6,
    tie_embeddings=True,
    norm_eps=1e-5,
    source="[arXiv:2411.15242; hf]",
)
