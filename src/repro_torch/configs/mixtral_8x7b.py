"""Mixtral-8x7B — sparse MoE (8 experts, top-2) with sliding-window
attention [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e6,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    source="[arXiv:2401.04088; hf]",
))
