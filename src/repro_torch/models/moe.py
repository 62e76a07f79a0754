"""Mixture-of-Experts FFN with capacity-based dispatch (port of the
reference's ``models/moe.py``).

Each (token, k) pair is an allocation request against its expert's
buffer of ``cap`` rows, ranked per expert within its batch row in one
prefix sum (one-hot cumsum minus itself); rank >= cap drops the pair
for that expert.  Capacity is per batch row (``cf * S * K / E``, or
``S * K`` with ``no_drop``, the decode path), so a row prefilled alone
equals the same row of a padded batch.

Fixed shapes and no read back to the host: the dispatch is a scatter
into a ``(B, E * cap + 1, D)`` buffer whose last row takes the dropped
pairs, the combine a gather from the expert outputs with a zero row
appended, so the mega-step's tick can run it under
``set_sync_debug_mode("error")``.  The experts are plain batched
products over ``(E, d, f)`` weights, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def moe_shapes(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def capacity(cfg: ModelConfig, S: int, no_drop: bool) -> int:
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    return S * K if no_drop else max(1, int(cfg.moe_capacity_factor
                                            * S * K / E))


def route(cfg: ModelConfig, router, x):
    """Router probabilities (B, S, E) float32 and the top-k experts
    (B, S, K) with their renormalised weights.  Ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them (a stable descending
    sort)."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    topw, topi = order.values[..., :K], order.indices[..., :K]
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    return probs, topi, topw


def apply_moe(cfg: ModelConfig, p, x, no_drop: bool = False):
    """x: (B, S, D) → (y (B, S, D) in x's dtype, aux loss float32)."""
    B, S, D = x.shape
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    cap = capacity(cfg, S, no_drop)
    probs, topi, topw = route(cfg, p["router"], x)

    flat_e = topi.reshape(B, S * K)                  # (B, S·K) int64
    flat_w = topw.reshape(B, S * K)
    onehot = (flat_e[..., None] == torch.arange(
        E, device=x.device)).to(torch.int32)         # (B, S·K, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(before, 2, flat_e[..., None])[..., 0]
    keep = rank < cap                                # capacity = success

    # dispatch: pair j of row b to row (e, rank) of its expert's buffer,
    # a dropped pair to the spare last row
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(rank, E * cap))
    src = x[:, :, None].expand(B, S, K, D).reshape(B, S * K, D)
    buf = torch.zeros((B, E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(B, S * K, D), src)
    buf = buf[:, :E * cap].reshape(B, E, cap, D)

    wd = x.dtype
    g = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"].to(wd)))
    u = torch.einsum("becd,edf->becf", buf, p["w_up"].to(wd))
    y_e = torch.einsum("becf,efd->becd", g * u, p["w_down"].to(wd))

    # combine: each kept pair's expert row, weighted; a dropped pair
    # reads the appended zero row
    y_e = torch.cat([y_e.reshape(B, E * cap, D),
                     torch.zeros((B, 1, D), dtype=wd, device=x.device)], 1)
    got = torch.gather(y_e, 1, slot[..., None].expand(B, S * K, D))
    y = (got * keep[..., None].to(wd) * flat_w[..., None].to(wd))
    y = y.reshape(B, S, K, D).sum(dim=2)

    # Switch-transformer load-balance loss: E · Σ_e f_e · P_e
    f_e = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e.reshape(-1), keep.reshape(-1).float()) / (B * S * K)
    aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))
    return y, aux
