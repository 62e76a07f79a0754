"""Parameters of the dense and MoE decoders and the Mamba-2 stack
(port): init from a seed, and the converter from the reference's
parameter tree.

The port's tree mirrors the reference's names with the layer axis
unstacked into a list::

    {"embed": (V_pad, d), "final_norm": {"scale": (d,)},
     "blocks": [{"norm1": {"scale"}, "attn": {"wq", "wk", "wv", "wo",
                 "bq", "bk", "bv"}, "norm2": {"scale"},
                 "ffn": {"w_gate", "w_up", "w_down"}}, ...],
     "lm_head": (d, V_pad)}     # only when embeddings are untied

where a MoE block's ``ffn`` is ``{"router" (d, E), "w_gate" (E, d, f),
"w_up" (E, d, f), "w_down" (E, f, d)}``, and an ssm block is
``{"norm": {"scale"}, "mixer": {"in_proj", "conv_w", "conv_b", "a_log",
"dt_bias", "d_skip", "norm_scale", "out_proj"}}``.

Matrices keep the reference's ``x @ W`` layout, W as (d_in, d_out), and
attention heads stay merged.  :func:`init` draws the same shapes and
distributions as the reference ``Model.init``: a normal leaf has
std = scale/sqrt(shape[0]) of its *stacked* spec, so every block matrix
(the router and the experts too) has std 1/sqrt(num_layers) (``conv_w``
1/sqrt(ssm_conv * num_layers)), the embedding 1/sqrt(V_pad) and
``lm_head`` 1/sqrt(d); norm scales, ``d_skip`` and ``norm_scale`` are
ones, biases (``conv_b`` too) zeros, ``a_log`` the constant log 4 and
``dt_bias`` the constant -3.  Each leaf is drawn in float32 and cast to
``dtype`` at once, layer by layer (every leaf of block 0, then block 1,
..., then ``embed`` and ``lm_head``), so a bf16 init holds the bf16
tree plus one float32 leaf: for qwen1.5-32b's 70.4 GB of bf16 weights,
at most its 3.1-GB float32 embedding (a layer's largest leaf, an MLP
matrix, is 0.56 GB), where drawing each stacked (64, 5120, 27392) leaf
whole would take 35.9 GB at once.  The numbers differ from the
reference's (a ``torch.Generator``, not a JAX key); tests that need the
same numbers convert the reference's tree with :func:`params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm

# leaves multiplied into activations: cast to the compute dtype once
_MATRICES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
             "w_down", "in_proj", "conv_w", "conv_b", "out_proj", "router",
             "lm_head")


def _block_shapes(cfg: ModelConfig):
    if cfg.family == "ssm":
        return {"norm": {"scale": (cfg.d_model,)},
                "mixer": Ssm.ssm_shapes(cfg)}
    hd, d, f = cfg.head_dim_, cfg.d_model, cfg.d_ff
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    attn = {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "wo": (nq, d)}
    if cfg.qkv_bias:
        attn.update(bq=(nq,), bk=(nkv,), bv=(nkv,))
    ffn = (Moe.moe_shapes(cfg) if cfg.num_experts else
           {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    return {"norm1": {"scale": (d,)}, "attn": attn, "norm2": {"scale": (d,)},
            "ffn": ffn}


def check_supported(cfg: ModelConfig):
    """The port runs the dense decoder as qwen2 configures it (RMSNorm,
    SwiGLU, rotate-half RoPE), the MoE decoder as mixtral and phi3.5-moe
    configure it (top-k experts, a sliding window, an untied
    ``lm_head``), and the Mamba-2 stack as mamba2 configures it.
    Anything else comes with its family (ROADMAP A12)."""
    unsupported = {
        "family": cfg.family not in ("dense", "moe", "ssm"),
        "num_experts": bool(cfg.num_experts) != (cfg.family == "moe"),
        "enc_layers": cfg.enc_layers, "norm": cfg.norm != "rmsnorm",
        "act": cfg.act != "silu", "parallel_block": cfg.parallel_block,
        "logit_softcap": cfg.logit_softcap,
        "mrope_sections": cfg.mrope_sections}
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} not ported yet (ROADMAP A12)")


def init(cfg: ModelConfig, seed: int, device="cpu",
         dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters from ``seed`` with the reference's shapes and
    distributions (see module docstring)."""
    check_supported(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    L = cfg.num_layers

    def normal(shape, fan_in, scale=1.0):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return (x * (scale / fan_in ** 0.5)).to(dtype)

    def leaf(group, name, shape):
        if group.startswith("norm") or name in ("d_skip", "norm_scale"):
            return torch.ones(shape, dtype=dtype, device=device)
        if name in ("bq", "bk", "bv", "conv_b"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if name in ("a_log", "dt_bias"):
            return torch.full(shape, math.log(4.0) if name == "a_log"
                              else -3.0, dtype=dtype, device=device)
        scale = 1.0 / math.sqrt(cfg.ssm_conv) if name == "conv_w" else 1.0
        return normal(shape, L, scale)  # stacked spec: fan_in = layers

    shapes = _block_shapes(cfg)
    blocks = [{grp: {nm: leaf(grp, nm, shp) for nm, shp in leaves.items()}
               for grp, leaves in shapes.items()} for _ in range(L)]
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"embed": normal((v, d), v),
           "final_norm": {"scale": torch.ones(d, dtype=dtype,
                                              device=device)},
           "blocks": blocks}
    if not cfg.tie_embeddings:
        out["lm_head"] = normal((d, v), d)
    return out


def params_from_jax(cfg: ModelConfig, tree, device="cpu") -> Dict[str, Any]:
    """Convert the reference ``Model.init`` tree, given as numpy arrays
    (``blocks/*`` stacked over layers), into the port's tree."""
    check_supported(cfg)

    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    blocks_np = tree["blocks"]
    blocks = []
    for i in range(cfg.num_layers):
        blocks.append({grp: {nm: t(np.asarray(arr)[i])
                             for nm, arr in leaves.items()}
                       for grp, leaves in blocks_np.items()})
    out = {"embed": t(tree["embed"]),
           "final_norm": {k: t(v) for k, v in tree["final_norm"].items()},
           "blocks": blocks}
    if not cfg.tie_embeddings:
        out["lm_head"] = t(tree["lm_head"])
    return out


def cast_for_compute(params, dtype) -> Dict[str, Any]:
    """A tree whose matrices, biases and embedding are already in the
    compute dtype, so no layer casts a weight per call.  Norm
    parameters stay as they are: the norms run in float32.  Casting
    once is numerically the same as the reference's cast at each use."""
    def blk(b):
        return {grp: {nm: (w.to(dtype) if nm in _MATRICES else w)
                      for nm, w in leaves.items()}
                for grp, leaves in b.items()}
    out = {"embed": params["embed"].to(dtype),
           "final_norm": params["final_norm"],
           "blocks": [blk(b) for b in params["blocks"]]}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(dtype)
    return out
