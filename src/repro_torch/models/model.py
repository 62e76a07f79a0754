"""Public model facade (port), dense decoder and Mamba-2 families:

    m = build_model(get_arch("qwen2-0.5b"))
    params = m.init(seed, device="cuda")
    caches = m.make_decode_caches(batch=8, max_seq=512, device="cuda")
    logits, caches = m.prefill(params, {"tokens": tokens}, caches)
    logits, caches = m.decode_step(params, tokens, caches)

Caches are updated in place (KV heaps and ``seq_lens``; the SSM states)
and returned.  An attention-free model (``ssm``) carries no KV: its
caches are the per-layer SSD state and conv tail, and ``prefill`` with
``Caches()`` returns them freshly stacked.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as Prm
from repro_torch.models import ssm as Ssm
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
        """Paged KV for the attention layers; for the ssm family, zero
        SSD states (float32) and conv tails.  The conv tail is kept in
        ``kv_dtype``: the reference keeps it in bf16, and its float32
        engines promote it to float32 at the first row merge."""
        cfg = self.cfg
        dev = resolve_device(device)
        page = KV.PAGE_SIZE
        pps = -(-max_seq // page)
        n_attn, n_rec = TF.num_attn_layers(cfg), TF.num_rec_layers(cfg)
        kv = ssm_h = ssm_conv = None
        if n_attn:
            kv = KV.init_paged_kv(
                n_attn, num_pages or batch * pps, batch, pps,
                cfg.num_kv_heads, cfg.head_dim_, kv_dtype, page, device=dev)
        if n_rec:
            ssm_h = torch.zeros((n_rec, batch, cfg.ssm_nheads,
                                 cfg.ssm_headdim, cfg.ssm_state),
                                dtype=torch.float32, device=dev)
            ssm_conv = torch.zeros((n_rec, batch, cfg.ssm_conv - 1,
                                    Ssm.conv_dim(cfg)), dtype=kv_dtype,
                                   device=dev)
        return TF.Caches(kv=kv, ssm_h=ssm_h, ssm_conv=ssm_conv)

    def prefill(self, params, batch, caches, dtype=torch.bfloat16):
        """Full-sequence pass that writes the decode caches.  Returns
        (last-position logits (B, V_pad) float32, caches with
        ``seq_lens`` advanced by the prompt length)."""
        tokens = batch["tokens"]
        logits, caches = TF.forward(self.cfg, params, tokens,
                                    positions=batch.get("positions"),
                                    mode="prefill", caches=caches,
                                    dtype=dtype)
        if caches.kv is not None:
            caches.kv.seq_lens.add_(tokens.shape[1])
        return logits[:, -1], caches

    def decode_step(self, params, tokens, caches, dtype=torch.bfloat16,
                    advance=None):
        """One token per sequence.  tokens: (B, 1).  Returns (logits
        (B, V_pad) float32, caches with every ``seq_lens`` advanced).
        ``advance`` (B,) bool advances only those rows' ``seq_lens`` (the
        mega-step's masked advance: a row left out must also have its
        K/V write land in a table hole, where it drops)."""
        logits, caches = TF.forward(self.cfg, params, tokens, mode="decode",
                                    caches=caches, dtype=dtype)
        if caches.kv is not None:
            caches.kv.seq_lens.add_(1 if advance is None
                                    else advance.to(torch.int32))
        return logits[:, 0], caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
