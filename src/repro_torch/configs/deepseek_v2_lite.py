# No counterpart in src/repro: the JAX package has no latent attention, no
# shared experts at a width of their own and no leading dense layer.
"""deepseek-v2-lite — latent attention (MLA), 64 routed experts of 1408 top-6
beside 2 shared ones, one leading dense layer.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]
27L d_model=2048 16H, kv_lora_rank 512, qk 128 + 64 rope, v 128, no q
compression; layer 0 a SwiGLU of 10944; YaRN rope (factor 40 over 4096);
softmax router, gates not renormalised; vocab 102400, untied head.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    d_ff=10944,                   # the leading dense layer's width
    vocab_size=102400,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=192,
                    rope_theta=10000.0),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128, rope_factor=40.0, original_max_position=4096,
                  beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                  mscale_all_dim=0.707),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2,
                  d_shared=2816, norm_topk=False, capacity_factor=1.25),
    n_dense_layers=1,
    max_seq_len=163840,
    norm_eps=1e-6,
    source="[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]",
)
