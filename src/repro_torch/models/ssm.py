"""Mamba-2 block (SSD, state-space duality) for mamba2-780m (port).

Prefill runs the chunked dual form through ``kernels/ops.ssd_scan``:
the CUDA kernel ``csrc/ssd_scan.cu`` on the card (one launch per layer),
its plain version ``ssd_plain`` on the CPU.  The sequence is padded to a
multiple of ``ssm_chunk`` with dt = 0 first, which is inert (decay 1,
zero input), as the reference's ``ssd_jnp`` pads.  Decode is the O(1)
recurrence on the persistent state in plain PyTorch, as the reference
computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


class SSMCache(NamedTuple):
    h: torch.Tensor          # (L, B, H, P, N) float32
    conv: torch.Tensor       # (L, B, conv-1, conv_dim)


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def ssm_shapes(cfg: ModelConfig):
    """Parameter shapes of one mixer layer (the reference's
    ``ssm_specs``), ``in_proj`` columns ordered [z | x | B | C | dt]."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    g, n, w = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv
    cd = conv_dim(cfg)
    return {"in_proj": (d, 2 * di + 2 * g * n + h), "conv_w": (w, cd),
            "conv_b": (cd,), "a_log": (h,), "dt_bias": (h,),
            "d_skip": (h,), "norm_scale": (di,), "out_proj": (di, d)}


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv over time.  x: (B, S, C); w: (W, C).
    ``state``: (B, W-1, C) left context (decode).  Returns (y, new_state)."""
    width = w.shape[0]
    ctx = (torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([ctx, x], dim=1)
    y = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, width):
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    new_state = xp[:, -(width - 1):, :] if width > 1 else ctx
    return y + b[None, None, :], new_state


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., di + di + 2 * g * n:]
    assert dt.shape[-1] == cfg.ssm_nheads
    return z, xbc, dt


def ssd_prefill(cfg: ModelConfig, xh, dt, a, b, c):
    """The chunked scan of a whole prompt from a zero state: L padded
    to a multiple of ``ssm_chunk`` with dt = 0, one ``ops.ssd_scan``,
    the padding cut off again.  Returns (y (B, S, H, P), h_final)."""
    S, q = xh.shape[1], cfg.ssm_chunk
    pad = (-S) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    y, hf = ops.ssd_scan(xh.contiguous(), dt.contiguous(), a,
                         b.contiguous(), c.contiguous(), chunk=q)
    return y[:, :S], hf


def apply_ssm_layer(cfg: ModelConfig, p, x, cache=None):
    """One Mamba-2 mixing layer.  x: (B, S, D).  cache: None (prefill
    from a zero state) or (h, conv_state) for single-token decode.
    Returns (y, (h_final, conv_state))."""
    B, S, _ = x.shape
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    H, P = cfg.ssm_nheads, cfg.ssm_headdim

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_state = None if cache is None else cache[1]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di]
    b = xbc[..., di:di + g * n].reshape(B, S, g, n)
    c = xbc[..., di + g * n:].reshape(B, S, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"].float())
    xh = xs.reshape(B, S, H, P)

    if cache is None:
        y, hf = ssd_prefill(cfg, xh, dt, a, b, c)
    else:
        h0 = cache[0]
        # O(1) decode recurrence (S == 1)
        decay = torch.exp(dt[:, 0] * a[None, :])             # (B, H)
        rep = H // g
        bh = torch.repeat_interleave(b[:, 0], rep, dim=1)    # (B, H, N)
        ch = torch.repeat_interleave(c[:, 0], rep, dim=1)
        hf = (h0 * decay[:, :, None, None]
              + (dt[:, 0, :, None] * xh[:, 0].float())[..., None]
              * bh[:, :, None, :].float())
        y = torch.einsum("bhpn,bhn->bhp", hf, ch.float())[:, None]

    y = y + p["d_skip"][None, None, :, None].float() * xh.float()
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + 1e-6)
         * p["norm_scale"][None, None, :]).to(x.dtype)
    return y @ p["out_proj"].to(x.dtype), (hf, new_conv)
