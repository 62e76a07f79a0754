"""Command-R 35B — dense LM, parallel attn+FFN block, layernorm, no bias
[hf:CohereForAI/c4ai-command-r-v01; unverified].

The JAX package's configuration, copied as it is, ``source`` included:
64 query heads over 8 kv heads of 128 (G 8), LayerNorm, one norm a
block feeding attention and the FFN side by side (``parallel_block``),
embeddings tied to a 256,000-token vocab.  Its bf16 weights are 30.3 B
parameters, 60.6 GB."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8e6,
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
))
