"""Transformer building blocks (port): norms (RMSNorm, LayerNorm), RoPE
and M-RoPE, blockwise flash attention (causal, sliding-window,
bidirectional and cross, with a per-row valid key length), GQA
projections and the gated MLP (SwiGLU or GeGLU).

``flash_attention`` is the reference's jnp blockwise online-softmax
scan written as plain matmul/softmax in PyTorch (no fused attention
call): it is XLA code in the reference, not a TPU kernel.  Products
whose reference accumulates in float32 (``preferred_element_type``)
cast their staged operands to float32 first, which is exact for bf16
inputs.  The large projections are ``torch.matmul``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_NEG = -1e30


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6):
    """RMSNorm, or LayerNorm (``scale`` and ``bias``) for
    ``norm="layernorm"``, computed in float32, cast back."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def rope_freqs(cfg: ModelConfig, device=None):
    hd = cfg.head_dim_
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (cfg.rope_theta ** (ar / hd))


def apply_rope(cfg: ModelConfig, x, positions):
    """Rotate-half RoPE.  x: (B, S, H, D); positions: (B, S) int, or
    (3, B, S) for M-RoPE (temporal, height and width streams; 2-D
    positions are broadcast to all three)."""
    inv = rope_freqs(cfg, x.device)
    if cfg.mrope_sections is not None:
        # frequency slot j rotates by the stream that owns its section
        # (sliced, not gathered: no index tensor to copy to the card)
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        ang, j = [], 0
        for i, n in enumerate(cfg.mrope_sections):
            ang.append(positions[i][..., None].float() * inv[j:j + n])
            j += n
        ang = torch.cat(ang, -1)                               # (B, S, D/2)
    else:
        ang = positions[..., None].float() * inv              # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def flash_attention(q, k, v, *, causal: bool, window=None,
                    kv_valid_len=None, block: int = 512):
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) → (B, S, Hq, D) float32.
    Online softmax over KV blocks of ``block``.  ``window``: sliding
    window width (None = full): key ``kpos`` is seen from query ``qpos``
    when ``qpos - kpos < window``.  ``kv_valid_len`` (B,) int: row b
    sees only keys ``kpos < kv_valid_len[b]`` (the cross-attention's
    padding mask); a row of valid length 0 comes out as zeros.  (The
    reference blocks q for S > 4096, which only bounds its live
    memory.)"""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    block = min(block, T)
    nblocks = -(-T // block)
    stage_dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qg = (q.reshape(B, S, Hkv, G, D) * (D ** -0.5)).to(stage_dt).float()
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32,
                      device=q.device)
    for i in range(nblocks):
        kb = k[:, i * block:(i + 1) * block].to(stage_dt).float()
        vb = v[:, i * block:(i + 1) * block].to(stage_dt).float()
        kpos = i * block + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bshgd,bthd->bhgst", qg, kb)
        mask = torch.ones((S, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        if kv_valid_len is not None:               # (B, 1, 1, S, block)
            mask = mask & (kpos[None, :] < kv_valid_len[:, None]
                           )[:, None, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bhgst,bthd->bhgsd", p.to(stage_dt).float(), vb)
        m = m_new
    out = acc / (l[..., None] + 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def qkv_project(cfg: ModelConfig, p, x, positions, *, rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if rope:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def attn_out(p, o, dtype):
    B, S = o.shape[:2]
    return o.to(dtype).reshape(B, S, -1) @ p["wo"].to(dtype)


def apply_mlp(cfg: ModelConfig, p, x):
    """SwiGLU, or GeGLU for ``act="gelu"`` with the tanh approximation
    (``jax.nn.gelu``'s default, which the reference calls)."""
    h = x @ p["w_gate"].to(x.dtype)
    g = F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)
