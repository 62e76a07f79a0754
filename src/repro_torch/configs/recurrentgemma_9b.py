"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 1 attention
block per 3 [arXiv:2402.19427; unverified].

The JAX package's configuration, copied as it is, ``source`` included:
38 layers as 12 (RG-LRU, RG-LRU, local attention) triples and 2 RG-LRU
layers, MQA (16 query heads on 1 kv head of 256), GeGLU, a 2,048-token
local window, untied embeddings.  The published model differs: it ties
its embeddings, scales them by sqrt(d_model), softcaps its logits and
uses (1 + scale) RMSNorm; no file of the repo holds its config.  At
these widths its bf16 weights (about 10.4 B parameters, 20.9 GB) fit
one 80-GB card at full depth."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    rope_theta=1e4,
    lru_width=4096,
    attn_period=3,
    local_window=2048,
    source="[arXiv:2402.19427; unverified]",
))
