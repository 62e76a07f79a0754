"""RG-LRU recurrent block (RecurrentGemma / Griffin) for the hybrid
family (port).

Griffin's recurrent temporal-mixing block: a GeLU gate branch and a
(causal conv -> RG-LRU) branch, multiplied and projected out.  The
recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(c * r_t * log_a),  log_a = -softplus(lambda_p)

is first-order and linear.  Prefill computes every h_t from a zero
state by :func:`linear_scan`, ceil(log2 S) doubling steps on whole
tensors (the reference's ``jax.lax.associative_scan`` with the same
combine, associated in another order: float32 roundings apart); decode
is the O(1) step from the cached state.  The reference reaches no
Pallas kernel here, so neither does the port: the block is plain
PyTorch.

Types as the reference keeps them: the gate branch, the conv and the
output projection run in the compute type; u, r_t, i_t, a_t, b_t and h
are float32, and ``w_rec_gate``/``w_input_gate`` multiply in float32.
The conv tail comes back in the compute type (the engine's cache holds
it in bf16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_C = 8.0
CONV_WIDTH = 4


def rglru_shapes(cfg: ModelConfig):
    """Parameter shapes of one mixer layer (the reference's
    ``rglru_specs``)."""
    d = cfg.d_model
    r = cfg.lru_width or d
    return {"w_gate_branch": (d, r), "w_rec_branch": (d, r),
            "conv_w": (CONV_WIDTH, r), "conv_b": (r,),
            "w_input_gate": (r, r), "w_rec_gate": (r, r),
            "lambda_p": (r,), "w_out": (r, d)}


def _conv(x, w, b, state=None):
    """Depthwise causal conv over time.  x: (B, S, R); w: (W, R);
    ``state``: (B, W-1, R) left context (decode), zeros at prefill.
    Returns (y, the last W-1 positions of the padded input)."""
    width = w.shape[0]
    ctx = (torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([ctx, x], dim=1)
    y = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, width):
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return y + b[None, None, :], xp[:, -(width - 1):, :]


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    Hillis-Steele doubling, ceil(log2 S) steps, each folding the pair d
    positions back into every later one with the reference's combine
    ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``."""
    d, S = 1, a.shape[1]
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def apply_rglru_layer(cfg: ModelConfig, p, x, cache=None):
    """x: (B, S, D); cache: None (prefill from a zero state) or
    (h (B, R) float32, conv_state (B, W-1, R)) for single-token decode.
    Returns (y (B, S, D), (h_last, conv_state))."""
    gate = F.gelu(x @ p["w_gate_branch"].to(x.dtype), approximate="tanh")
    u = x @ p["w_rec_branch"].to(x.dtype)
    u, new_conv = _conv(u, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                        None if cache is None else cache[1])

    uf = u.float()
    r_t = torch.sigmoid(uf @ p["w_rec_gate"].float())
    i_t = torch.sigmoid(uf @ p["w_input_gate"].float())
    lam = p["lambda_p"].float()
    log_a = -torch.logaddexp(lam, torch.zeros_like(lam))   # -softplus
    a_t = torch.exp(_C * r_t * log_a[None, None, :])          # (B, S, R)
    b_t = torch.sqrt(torch.clamp(1.0 - a_t ** 2, min=1e-12)) * (i_t * uf)

    if cache is None:
        h = linear_scan(a_t, b_t)
        h_last = h[:, -1]
    else:
        h = (a_t[:, 0] * cache[0] + b_t[:, 0])[:, None]
        h_last = h[:, 0]
    y = (gate * h.to(x.dtype)) @ p["w_out"].to(x.dtype)
    return y, (h_last, new_conv)
