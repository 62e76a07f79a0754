"""SeamlessM4T-large-v2 — speech/text encoder-decoder [arXiv:2308.11596; hf].

Enc-dec transformer backbone; the w2v-BERT speech frontend is a stub
(the serving engine feeds the encoder zero frame embeddings, as the
reference's does).  The 24 layers are instantiated as 24 encoder + 24
decoder layers (the published text-to-text stack is 24+24).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,       # decoder
    enc_layers=24,       # encoder
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    rope_theta=1e4,
    modality="audio",
    source="[arXiv:2308.11596; hf]",
))
