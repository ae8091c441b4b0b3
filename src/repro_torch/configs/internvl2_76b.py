# Counterpart of src/repro/configs/internvl2_76b.py: the same data, nothing left unported.
"""internvl2-76b — VLM: InternViT frontend (STUB patch embeddings) +
InternLM2-76B-style LM backbone.  [arXiv:2404.16821; unverified]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    d_ff=28672,
    vocab_size=128256,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                    rope_theta=1000000.0),
    n_patches=256,
    norm_eps=1e-5,
    source="[arXiv:2404.16821; unverified]",
)
