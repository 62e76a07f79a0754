"""Decoder-only LM assembly, dense, MoE and SSM stacks (port).

``mode`` selects the path: ``train`` (full-sequence mixing, no cache),
``prefill`` (full-sequence mixing + paged-KV writes, or the SSM final
states) and ``decode`` (one token against the paged cache, or the O(1)
SSM recurrence).  Layers run in a Python loop over the unstacked
parameter list; the KV heaps and the SSM state caches are written in
place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm
from repro_torch.paged import kv_cache as KV


class Caches(NamedTuple):
    """Decode-time state, stacked over its layer population."""
    kv: Optional[KV.PagedKV] = None      # attention layers
    ssm_h: Optional[torch.Tensor] = None     # (Lr, B, H, P, N) float32
    ssm_conv: Optional[torch.Tensor] = None  # (Lr, B, W-1, conv_dim)


def num_attn_layers(cfg: ModelConfig) -> int:
    return 0 if cfg.family == "ssm" else cfg.num_layers


def num_rec_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers if cfg.family == "ssm" else 0


def _attn_mix(cfg, p, x, positions, mode, kvl, page_table, seq_lens,
              window):
    q, k, v = Lyr.qkv_project(cfg, p, x, positions)
    # windowed layers address their pages through ring tables (slot =
    # page index mod P), as the reference sets it for every windowed
    # decode and prefill; a table that covers the sequence is the
    # identity ring
    ring = (window is not None and page_table is not None
            and mode in ("decode", "prefill"))
    if mode == "decode":
        KV.append1(kvl, page_table, seq_lens, k, v, ring=ring)
        o = KV.paged_attend1(kvl, page_table, seq_lens + 1, q,
                             window=window, ring=ring)
    else:
        o = Lyr.flash_attention(q, k, v, causal=True, window=window)
        if mode == "prefill":
            KV.prefill_write1(kvl, page_table, k, v, ring=ring)
    return Lyr.attn_out(p, o, x.dtype)


def _ffn(cfg, p, x, mode):
    """The block's FFN: the experts (no capacity drops at decode) or the
    gated MLP.  The MoE aux loss is a training term; serving drops it."""
    if cfg.num_experts:
        return Moe.apply_moe(cfg, p, x, no_drop=(mode == "decode"))[0]
    return Lyr.apply_mlp(cfg, p, x)


def dense_block(cfg, p, x, positions, mode, kvl, page_table, seq_lens):
    h = Lyr.apply_norm(cfg, p["norm1"], x)
    x = x + _attn_mix(cfg, p["attn"], h, positions, mode, kvl, page_table,
                      seq_lens, cfg.sliding_window)
    h = Lyr.apply_norm(cfg, p["norm2"], x)
    return x + _ffn(cfg, p["ffn"], h, mode)


def ssm_block(cfg, p, x, mode, cache):
    h = Lyr.apply_norm(cfg, p["norm"], x)
    y, new_cache = Ssm.apply_ssm_layer(
        cfg, p["mixer"], h, cache if mode == "decode" else None)
    return x + y, new_cache


def _ssm_stack(cfg, params, x, mode, caches: Caches):
    """The Mamba-2 layers.  Decode reads and rewrites each layer's state
    in place; prefill writes the final states into ``caches`` when it
    holds state tensors (the engine passes its slot's rows), and returns
    them stacked otherwise."""
    if mode == "decode" and caches.ssm_h is None:
        raise ValueError("mode 'decode' needs SSM state caches")
    hs, convs = [], []
    for i, p_l in enumerate(params["blocks"]):
        cache = ((caches.ssm_h[i], caches.ssm_conv[i]) if mode == "decode"
                 else None)
        x, (h_l, conv_l) = ssm_block(cfg, p_l, x, mode, cache)
        if caches.ssm_h is not None and mode != "train":
            caches.ssm_h[i].copy_(h_l)
            caches.ssm_conv[i].copy_(conv_l)
        else:
            hs.append(h_l)
            convs.append(conv_l)
    if hs and mode == "prefill":
        caches = caches._replace(ssm_h=torch.stack(hs),
                                 ssm_conv=torch.stack(convs))
    return x, caches


def uniform_stack(cfg, params, x, positions, mode, caches: Caches):
    """The layers of a dense, MoE or SSM stack; returns (x, caches)."""
    if cfg.family == "ssm":
        return _ssm_stack(cfg, params, x, mode, caches)
    kv = caches.kv
    if mode in ("prefill", "decode") and kv is None:
        raise ValueError(f"mode {mode!r} needs paged KV caches")
    for i, p_l in enumerate(params["blocks"]):
        kvl = None if kv is None else kv.layer(i)
        x = dense_block(cfg, p_l, x, positions, mode, kvl,
                        None if kv is None else kv.page_table,
                        None if kv is None else kv.seq_lens)
    return x, caches


def embed(cfg, params, tokens, dtype=torch.bfloat16):
    return params["embed"].to(dtype)[tokens]


def unembed(cfg, params, x):
    """Logits over the padded vocab, float32, from the tied embedding or
    the untied ``lm_head``."""
    h = Lyr.apply_norm(cfg, params["final_norm"], x)
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (h @ w.to(h.dtype)).float()


def forward(cfg: ModelConfig, params, tokens, positions=None, mode="train",
            caches: Caches = Caches(), dtype=torch.bfloat16):
    """Returns (logits, caches); prefill keeps only the last position."""
    B, S = tokens.shape
    if positions is None:
        if mode == "decode" and caches.kv is not None:
            positions = caches.kv.seq_lens[:, None].to(torch.int64)
        elif mode == "decode":
            positions = torch.zeros((B, 1), dtype=torch.int64,
                                    device=tokens.device)
        else:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
    x = embed(cfg, params, tokens, dtype)
    x, caches = uniform_stack(cfg, params, x, positions, mode, caches)
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(cfg, params, x), caches
