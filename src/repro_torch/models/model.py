"""Public model facade (port), dense and MoE decoders and the Mamba-2
family:

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


def kv_dtype_for(cfg: ModelConfig, seq_len: int, batch: int):
    """The reference's rule for the KV page type: int8 pages when the
    bf16 K and V of every attention layer at ``batch`` x ``seq_len``
    tokens would pass 2.5e12 bytes (qwen1.5-32b at 64 x 32,768), else
    bf16.

    >>> from repro_torch.configs import get_arch
    >>> kv_dtype_for(get_arch("qwen1.5-32b"), 32768, 64)
    torch.int8
    >>> kv_dtype_for(get_arch("qwen1.5-32b"), 1024, 8)
    torch.bfloat16
    """
    layers = TF.num_attn_layers(cfg)
    bytes_bf16 = (2 * layers * batch * seq_len * cfg.num_kv_heads
                  * cfg.head_dim_ * 2)
    return torch.int8 if bytes_bf16 > 2.5e12 else torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        Prm.check_supported(self.cfg)

    def init(self, seed: int = 0, device="cuda", dtype=torch.float32):
        """Random parameters from ``seed`` (float32 masters, as the
        reference's ``init``; ``dtype=torch.bfloat16`` casts each leaf
        as it is drawn, for a model whose float32 tree does not fit)."""
        return Prm.init(self.cfg, seed, resolve_device(device), dtype)

    def make_decode_caches(self, batch: int, max_seq: int, kv_dtype=None,
                           num_pages: Optional[int] = None, device="cuda"):
        """Paged KV for the attention layers, in ``kv_dtype`` (None: as
        :func:`kv_dtype_for` picks; int8 pages carry their scales); for
        the ssm family, zero SSD states (float32) and conv tails.  The
        conv tail is bf16, or float32 with float32 KV: the reference
        keeps it in bf16 whatever the KV type, and its float32 engines
        promote it to float32 at the first row merge."""
        cfg = self.cfg
        dev = resolve_device(device)
        kv_dtype = kv_dtype or kv_dtype_for(cfg, max_seq, batch)
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
            conv_dtype = (torch.float32 if kv_dtype == torch.float32
                          else torch.bfloat16)
            ssm_conv = torch.zeros((n_rec, batch, cfg.ssm_conv - 1,
                                    Ssm.conv_dim(cfg)), dtype=conv_dtype,
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
