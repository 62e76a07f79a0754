"""Decoder-only LM assembly, dense path (port).

``mode`` selects the path: ``train`` (full-sequence mixing, no cache),
``prefill`` (full-sequence mixing + paged-KV writes) and ``decode``
(one token against the paged cache).  Layers run in a Python loop over
the unstacked parameter list; the KV heaps are written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.paged import kv_cache as KV


class Caches(NamedTuple):
    """Decode-time state (the dense path carries paged KV only)."""
    kv: Optional[KV.PagedKV] = None


def _attn_mix(cfg, p, x, positions, mode, kvl, page_table, seq_lens):
    q, k, v = Lyr.qkv_project(cfg, p, x, positions)
    if mode == "decode":
        KV.append1(kvl, page_table, seq_lens, k, v)
        o = KV.paged_attend1(kvl, page_table, seq_lens + 1, q)
    else:
        o = Lyr.flash_attention(q, k, v, causal=True)
        if mode == "prefill":
            KV.prefill_write1(kvl, page_table, k, v)
    return Lyr.attn_out(p, o, x.dtype)


def dense_block(cfg, p, x, positions, mode, kvl, page_table, seq_lens):
    h = Lyr.apply_norm(cfg, p["norm1"], x)
    x = x + _attn_mix(cfg, p["attn"], h, positions, mode, kvl, page_table,
                      seq_lens)
    h = Lyr.apply_norm(cfg, p["norm2"], x)
    return x + Lyr.apply_mlp(cfg, p["ffn"], h)


def uniform_stack(cfg, params, x, positions, mode, caches: Caches):
    kv = caches.kv
    if mode in ("prefill", "decode") and kv is None:
        raise ValueError(f"mode {mode!r} needs paged KV caches")
    for i, p_l in enumerate(params["blocks"]):
        kvl = None if kv is None else kv.layer(i)
        x = dense_block(cfg, p_l, x, positions, mode, kvl,
                        None if kv is None else kv.page_table,
                        None if kv is None else kv.seq_lens)
    return x


def embed(cfg, params, tokens, dtype=torch.bfloat16):
    return params["embed"].to(dtype)[tokens]


def unembed(cfg, params, x):
    """Logits over the padded vocab from the tied embedding, float32."""
    h = Lyr.apply_norm(cfg, params["final_norm"], x)
    return (h @ params["embed"].T.to(h.dtype)).float()


def forward(cfg: ModelConfig, params, tokens, positions=None, mode="train",
            caches: Caches = Caches(), dtype=torch.bfloat16):
    """Returns (logits, caches); prefill keeps only the last position."""
    B, S = tokens.shape
    if positions is None:
        if mode == "decode":
            positions = caches.kv.seq_lens[:, None].to(torch.int64)
        else:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
    x = embed(cfg, params, tokens, dtype)
    x = uniform_stack(cfg, params, x, positions, mode, caches)
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(cfg, params, x), caches
