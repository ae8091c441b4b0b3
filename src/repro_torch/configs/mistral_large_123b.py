# Counterpart of src/repro/configs/mistral_large_123b.py: the same data, nothing left unported.
"""mistral-large-123b — dense GQA.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    attn=AttnConfig(n_heads=96, n_kv_heads=8, head_dim=128,
                    rope_theta=1000000.0),
    norm_eps=1e-5,
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
)
