"""Public model facade (port), dense decoder family:

    m = build_model(get_arch("qwen2-0.5b"))
    params = m.init(seed, device="cuda")
    caches = m.make_decode_caches(batch=8, max_seq=512, device="cuda")
    logits, caches = m.prefill(params, {"tokens": tokens}, caches)
    logits, caches = m.decode_step(params, tokens, caches)

Caches are updated in place (KV heaps and ``seq_lens``) and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as Prm
from repro_torch.models import transformer as TF
from repro_torch.paged import kv_cache as KV


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        Prm.check_supported(self.cfg)

    def init(self, seed: int = 0, device="cuda", dtype=torch.float32):
        """Random parameters from ``seed`` (float32 masters, as the
        reference's ``init``)."""
        return Prm.init(self.cfg, seed, resolve_device(device), dtype)

    def make_decode_caches(self, batch: int, max_seq: int,
                           kv_dtype=torch.bfloat16,
                           num_pages: Optional[int] = None, device="cuda"):
        cfg = self.cfg
        page = KV.PAGE_SIZE
        pps = -(-max_seq // page)
        return TF.Caches(kv=KV.init_paged_kv(
            cfg.num_layers, num_pages or batch * pps, batch, pps,
            cfg.num_kv_heads, cfg.head_dim_, kv_dtype, page,
            device=resolve_device(device)))

    def prefill(self, params, batch, caches, dtype=torch.bfloat16):
        """Full-sequence pass that writes the decode caches.  Returns
        (last-position logits (B, V_pad) float32, caches with
        ``seq_lens`` advanced by the prompt length)."""
        tokens = batch["tokens"]
        logits, caches = TF.forward(self.cfg, params, tokens,
                                    positions=batch.get("positions"),
                                    mode="prefill", caches=caches,
                                    dtype=dtype)
        caches.kv.seq_lens.add_(tokens.shape[1])
        return logits[:, -1], caches

    def decode_step(self, params, tokens, caches, dtype=torch.bfloat16):
        """One token per sequence.  tokens: (B, 1).  Returns (logits
        (B, V_pad) float32, caches with every ``seq_lens`` advanced)."""
        logits, caches = TF.forward(self.cfg, params, tokens, mode="decode",
                                    caches=caches, dtype=dtype)
        caches.kv.seq_lens.add_(1)
        return logits[:, 0], caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
