# Counterpart of src/repro/configs/gemma3_4b.py: the same data, nothing left unported.
"""gemma3-4b — dense, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
34L d_model=2560 8H (GQA kv=4) head_dim=256 d_ff=10240 vocab=262144.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262144,
    attn=AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256, qk_norm=True,
                    local_window=1024, global_every=6, rope_theta=1000000.0),
    tie_embeddings=True,
    act="gelu",
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
