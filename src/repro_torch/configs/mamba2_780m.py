"""Mamba2-780M — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060; unverified].  d_inner = 2×1536 = 3072, 48 SSD heads
of dim 64, state N=128."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,      # attention-free; SSD heads derived from d_inner
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv=4,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
))
