"""Qwen2-VL-2B — vision-language backbone [arXiv:2409.12191; hf].

M-RoPE (temporal/height/width sections) and dynamic-resolution vision;
the vision frontend is a stub: precomputed patch embeddings
(``mm_embeds``) are added to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    modality="vision",
    source="[arXiv:2409.12191; hf]",
))
