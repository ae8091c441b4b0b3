# Counterpart of src/repro/configs/mamba2_780m.py: the same data, nothing left unported.
"""mamba2-780m — attention-free SSD (state-space duality) LM.
[arXiv:2405.21060; unverified]  48L d_model=1536 d_ff=0 vocab=50280 state=128.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=256),
    tie_embeddings=True,
    norm_eps=1e-5,
    source="[arXiv:2405.21060; unverified]",
)
