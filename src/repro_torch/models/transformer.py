"""Decoder-only LM assembly, dense, MoE, SSM and hybrid stacks (port).

``mode`` selects the path: ``train`` (full-sequence mixing, no cache),
``prefill`` (full-sequence mixing + paged-KV writes, and the recurrent
layers' final states) and ``decode`` (one token against the paged
cache and the O(1) recurrences).  Layers run in a Python loop over the
unstacked parameter list; the KV heaps and the recurrent state caches
are written in place.

The hybrid stack (recurrentgemma) is the reference's: num_layers // 3
(RG-LRU, RG-LRU, local attention) triples, then the num_layers % 3
RG-LRU layers left.  Its state caches keep the reference's layout, not
the layer order: rows [0, T) hold the first recurrent layer of each of
the T triples, [T, 2T) the second, and [2T, 2T + tail) the tail.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.models import moe as Moe
from repro_torch.models import rglru as Rgl
from repro_torch.models import ssm as Ssm
from repro_torch.paged import kv_cache as KV


class Caches(NamedTuple):
    """Decode-time state, stacked over its layer population."""
    kv: Optional[KV.PagedKV] = None      # attention layers
    # (Lr, B, H, P, N) float32, or (Lr, B, R) for the hybrid's RG-LRU
    ssm_h: Optional[torch.Tensor] = None
    ssm_conv: Optional[torch.Tensor] = None  # (Lr, B, W-1, conv_dim or R)


def num_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    return cfg.num_layers


def num_rec_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers - cfg.num_layers // cfg.attn_period
    return 0


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


def dense_block(cfg, p, x, positions, mode, kvl, page_table, seq_lens,
                window=None):
    """Attention (``window``: the hybrid's local window, else the
    config's sliding window) and the FFN, each behind its norm; a
    parallel block (command-r) feeds both from ``norm1`` and adds them
    to ``x`` in the reference's order, ``x + a + f``."""
    h = Lyr.apply_norm(cfg, p["norm1"], x)
    a = _attn_mix(cfg, p["attn"], h, positions, mode, kvl, page_table,
                  seq_lens, window or cfg.sliding_window)
    if cfg.parallel_block:
        return x + a + _ffn(cfg, p["ffn"], h, mode)
    x = x + a
    h = Lyr.apply_norm(cfg, p["norm2"], x)
    return x + _ffn(cfg, p["ffn"], h, mode)


def ssm_block(cfg, p, x, mode, cache):
    h = Lyr.apply_norm(cfg, p["norm"], x)
    y, new_cache = Ssm.apply_ssm_layer(
        cfg, p["mixer"], h, cache if mode == "decode" else None)
    return x + y, new_cache


def rec_block(cfg, p, x, mode, cache):
    """The hybrid's recurrent block: RG-LRU mixer, then the gated MLP."""
    h = Lyr.apply_norm(cfg, p["norm1"], x)
    y, new_cache = Rgl.apply_rglru_layer(
        cfg, p["mixer"], h, cache if mode == "decode" else None)
    x = x + y
    h = Lyr.apply_norm(cfg, p["norm2"], x)
    return x + Lyr.apply_mlp(cfg, p["ffn"], h), new_cache


class _RecStates:
    """The recurrent layers' state rows.  Decode reads row ``i`` and
    rewrites it in place (with ``rows``, (B,) bool, only the rows that
    advance: the mega-step's masked tick keeps a failed slot's state for
    its retry, as the reference's row merge keeps it); prefill writes
    the final states into ``caches`` when it holds state tensors (the
    engine passes its slot's rows), and returns them stacked
    otherwise."""

    def __init__(self, caches: Caches, mode, rows=None):
        if mode == "decode" and caches.ssm_h is None:
            raise ValueError("mode 'decode' needs recurrent state caches")
        self.caches, self.mode, self.rows = caches, mode, rows
        self.made = {}

    def get(self, i):
        c = self.caches
        return (c.ssm_h[i], c.ssm_conv[i]) if self.mode == "decode" else None

    def put(self, i, h, conv):
        c = self.caches
        if self.mode == "train":
            return
        if c.ssm_h is None:
            self.made[i] = (h, conv)
            return
        if self.rows is not None:
            def keep(new, old):
                m = self.rows.view(-1, *([1] * (new.dim() - 1)))
                return torch.where(m, new.to(old.dtype), old)
            h, conv = keep(h, c.ssm_h[i]), keep(conv, c.ssm_conv[i])
        c.ssm_h[i].copy_(h)
        c.ssm_conv[i].copy_(conv)

    def result(self) -> Caches:
        if not self.made:
            return self.caches
        order = sorted(self.made)
        return self.caches._replace(
            ssm_h=torch.stack([self.made[i][0] for i in order]),
            ssm_conv=torch.stack([self.made[i][1] for i in order]))


def _needs_kv(kv, mode):
    if mode in ("prefill", "decode") and kv is None:
        raise ValueError(f"mode {mode!r} needs paged KV caches")


def uniform_stack(cfg, params, x, positions, mode, caches: Caches,
                  rows=None):
    """The layers of a dense, MoE or SSM stack; returns (x, caches)."""
    if cfg.family == "ssm":
        st = _RecStates(caches, mode, rows)
        for i, p_l in enumerate(params["blocks"]):
            x, (h, conv) = ssm_block(cfg, p_l, x, mode, st.get(i))
            st.put(i, h, conv)
        return x, st.result()
    kv = caches.kv
    _needs_kv(kv, mode)
    for i, p_l in enumerate(params["blocks"]):
        kvl = None if kv is None else kv.layer(i)
        x = dense_block(cfg, p_l, x, positions, mode, kvl,
                        None if kv is None else kv.page_table,
                        None if kv is None else kv.seq_lens)
    return x, caches


def hybrid_stack(cfg, params, x, positions, mode, caches: Caches,
                 rows=None):
    """recurrentgemma: the (rec, rec, local attention) triples, then the
    recurrent tail; the attention layers use ``cfg.local_window`` with
    ring tables, as the reference's (a stack of fewer layers than a
    triple has no attention layer and no KV).  Returns (x, caches)."""
    kv = caches.kv
    ntri = len(params["triples"])
    if ntri:
        _needs_kv(kv, mode)
    st = _RecStates(caches, mode, rows)
    for t, p_t in enumerate(params["triples"]):
        for i, name in ((t, "rec1"), (ntri + t, "rec2")):
            x, (h, conv) = rec_block(cfg, p_t[name], x, mode, st.get(i))
            st.put(i, h, conv)
        x = dense_block(cfg, p_t["attn"], x, positions, mode,
                        None if kv is None else kv.layer(t),
                        None if kv is None else kv.page_table,
                        None if kv is None else kv.seq_lens,
                        window=cfg.local_window)
    for j, p_l in enumerate(params["tail"]):
        x, (h, conv) = rec_block(cfg, p_l, x, mode, st.get(2 * ntri + j))
        st.put(2 * ntri + j, h, conv)
    return x, st.result()


def embed(cfg, params, tokens, extra_embeds=None, dtype=torch.bfloat16):
    """Token embeddings in ``dtype``, plus ``extra_embeds`` (B, S, d)
    (the VLM's stub patch embeddings, ``mm_embeds``) cast to ``dtype``
    first, as the reference adds them."""
    x = params["embed"].to(dtype)[tokens]
    if extra_embeds is not None:
        x = x + extra_embeds.to(dtype)
    return x


def unembed(cfg, params, x):
    """Logits over the padded vocab, float32, from the tied embedding or
    the untied ``lm_head``."""
    h = Lyr.apply_norm(cfg, params["final_norm"], x)
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (h @ w.to(h.dtype)).float()


def forward(cfg: ModelConfig, params, tokens, positions=None,
            extra_embeds=None, mode="train", caches: Caches = Caches(),
            dtype=torch.bfloat16, rows=None):
    """Returns (logits, caches); prefill keeps only the last position.
    ``positions``: (B, S), or M-RoPE's three streams batch-first (B, 3,
    S), as batches carry them; ``extra_embeds``: see :func:`embed`.
    ``rows`` (B,) bool: at decode, only these rows' recurrent states are
    rewritten."""
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
    elif positions.dim() == 3 and positions.shape[1] == 3:
        positions = positions.transpose(0, 1)       # rope wants (3, B, S)
    x = embed(cfg, params, tokens, extra_embeds, dtype)
    stack = hybrid_stack if cfg.family == "hybrid" else uniform_stack
    x, caches = stack(cfg, params, x, positions, mode, caches, rows)
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(cfg, params, x), caches
