"""Encoder-decoder assembly (port; seamless-m4t): a bidirectional
encoder over stub frame embeddings, then a causal decoder with
cross-attention.

Decode caches: the decoder's paged self-attention KV (grows a token at
a time out of the allocator, decoded through the paged attention
kernel) and a dense cross-attention K/V per decoder layer, computed once
at prefill from the encoder output (fixed size, so it stays a plain
tensor) and masked by each row's valid encoder length.  Cross-attention
is plain attention in the reference too (no Pallas kernel): it runs
through :func:`layers.flash_attention` here, with no RoPE on q, k or v.

Prefill writes the cross K/V and ``enc_valid`` into ``caches`` in place
when it holds them (the engine passes its admitted row's slices), and
returns them freshly stacked otherwise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.models.transformer import unembed
from repro_torch.paged import kv_cache as KV


class EncDecCaches(NamedTuple):
    self_kv: Optional[KV.PagedKV] = None    # decoder self-attention, paged
    cross_k: Optional[torch.Tensor] = None  # (Ld, B, Se, Hkv, hd)
    cross_v: Optional[torch.Tensor] = None
    enc_valid: Optional[torch.Tensor] = None  # (B,) int32 valid lengths


def encode(cfg: ModelConfig, params, src_embeds, dtype=torch.bfloat16):
    """src_embeds: (B, Se, d) stub frontend output → (B, Se, d): RoPE at
    positions 0..Se-1, bidirectional self-attention over every frame
    (the encoder has no padding mask, as the reference's)."""
    x = src_embeds.to(dtype) @ params["enc_in"].to(dtype)
    B, Se, _ = x.shape
    pos = torch.arange(Se, device=x.device)[None].expand(B, Se)
    for p_l in params["enc_blocks"]:
        h = Lyr.apply_norm(cfg, p_l["norm1"], x)
        q, k, v = Lyr.qkv_project(cfg, p_l["attn"], h, pos)
        o = Lyr.flash_attention(q, k, v, causal=False)
        x = x + Lyr.attn_out(p_l["attn"], o, x.dtype)
        h = Lyr.apply_norm(cfg, p_l["norm2"], x)
        x = x + Lyr.apply_mlp(cfg, p_l["ffn"], h)
    return Lyr.apply_norm(cfg, params["enc_norm"], x)


def _cross_kv(cfg: ModelConfig, p, enc_out):
    """Cross-attention K/V from the encoder output (no RoPE)."""
    B, S, _ = enc_out.shape
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    hd = cfg.head_dim_
    return (k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def decode_stack(cfg: ModelConfig, params, tokens, enc_out, mode,
                 caches: EncDecCaches, dtype=torch.bfloat16):
    """The decoder over target tokens.  ``mode`` train/prefill: the full
    causal pass with cross-attention against ``enc_out`` (prefill also
    writes the paged self K/V and the cross K/V); decode: one token
    against the caches.  Returns (logits float32, caches); prefill
    keeps only the last position."""
    B, S = tokens.shape
    x = params["embed"].to(dtype)[tokens]
    kv = caches.self_kv
    if mode in ("prefill", "decode") and kv is None:
        raise ValueError(f"mode {mode!r} needs paged KV caches")
    if mode == "decode":
        if caches.cross_k is None:
            raise ValueError("mode 'decode' needs the cross-attention K/V")
        pos = kv.seq_lens[:, None].to(torch.int64)
    else:
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    made = []
    for i, p_l in enumerate(params["dec_blocks"]):
        h = Lyr.apply_norm(cfg, p_l["norm1"], x)
        q, k, v = Lyr.qkv_project(cfg, p_l["attn"], h, pos)
        if mode == "decode":
            kvl = kv.layer(i)
            KV.append1(kvl, kv.page_table, kv.seq_lens, k, v)
            o = KV.paged_attend1(kvl, kv.page_table, kv.seq_lens + 1, q)
        else:
            o = Lyr.flash_attention(q, k, v, causal=True)
            if mode == "prefill":
                KV.prefill_write1(kv.layer(i), kv.page_table, k, v)
        x = x + Lyr.attn_out(p_l["attn"], o, x.dtype)

        h = Lyr.apply_norm(cfg, p_l["norm_x"], x)
        px = p_l["xattn"]
        qx = h @ px["wq"].to(h.dtype)
        if cfg.qkv_bias:
            qx = qx + px["bq"].to(h.dtype)
        qx = qx.reshape(B, S, cfg.num_heads, cfg.head_dim_)
        if mode == "decode":
            kx, vx = caches.cross_k[i], caches.cross_v[i]
        else:
            kx, vx = _cross_kv(cfg, px, enc_out)
            if mode == "prefill" and caches.cross_k is not None:
                caches.cross_k[i].copy_(kx)
                caches.cross_v[i].copy_(vx)
            elif mode == "prefill":
                made.append((kx, vx))
        ox = Lyr.flash_attention(qx, kx, vx, causal=False,
                                 kv_valid_len=caches.enc_valid)
        x = x + Lyr.attn_out(px, ox, x.dtype)

        h = Lyr.apply_norm(cfg, p_l["norm2"], x)
        x = x + Lyr.apply_mlp(cfg, p_l["ffn"], h)
    if made:
        caches = caches._replace(cross_k=torch.stack([m[0] for m in made]),
                                 cross_v=torch.stack([m[1] for m in made]))
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(cfg, params, x), caches
