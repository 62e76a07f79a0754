"""Qwen1.5-32B — dense decoder LM with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

The JAX package's configuration, copied as it is, ``source`` included:
40 query and 40 kv heads (no GQA folding), untied embeddings.  Its kv
head count and ``source`` may differ from the published Qwen1.5-32B
config.json, which no file of the repo holds.  At these widths its bf16
weights (35.2 B parameters, 70.4 GB) leave little of an 80-GB card for
KV pages."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
))
