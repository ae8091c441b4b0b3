# Counterpart of src/repro/configs/whisper_tiny.py: the same data, nothing left unported.
"""whisper-tiny — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356;
unverified]  4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_enc_layers=4,
    n_frames=1500,
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    attn=AttnConfig(n_heads=6, n_kv_heads=6, head_dim=64),
    tie_embeddings=True,
    act="gelu",
    glu=False,
    norm_eps=1e-5,
    source="[arXiv:2212.04356; unverified]",
)
