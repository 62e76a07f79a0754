"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    rope_theta=1e4,
    num_experts=16,
    num_experts_per_tok=2,
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
))
