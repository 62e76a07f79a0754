"""InternLM2-20B — dense decoder LM with GQA [arXiv:2403.17297; hf].

The JAX package's configuration, copied as it is, ``source`` included:
48 query heads over 8 kv heads of 128 (G 6), untied embeddings, vocab
92,544 (padded to 92,672).  Its bf16 weights are 19.9 B parameters,
39.7 GB."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    head_dim=128,
    rope_theta=1e6,
    source="[arXiv:2403.17297; hf]",
))
