"""Parameters of the dense decoder (port): init from a seed, and the
converter from the reference's parameter tree.

The port's tree mirrors the reference's names with the layer axis
unstacked into a list::

    {"embed": (V_pad, d), "final_norm": {"scale": (d,)},
     "blocks": [{"norm1": {"scale"}, "attn": {"wq", "wk", "wv", "wo",
                 "bq", "bk", "bv"}, "norm2": {"scale"},
                 "ffn": {"w_gate", "w_up", "w_down"}}, ...]}

Matrices keep the reference's ``x @ W`` layout, W as (d_in, d_out), and
attention heads stay merged.  :func:`init` draws the same shapes and
distributions as the reference ``Model.init``: a normal leaf has
std = 1/sqrt(shape[0]) of its *stacked* spec, so every block matrix has
std 1/sqrt(num_layers) and the embedding 1/sqrt(V_pad); norm scales
are ones and biases zeros.  The numbers differ (a ``torch.Generator``,
not a JAX key); tests that need the same numbers convert the
reference's tree with :func:`params_from_jax`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# leaves multiplied into activations: cast to the compute dtype once
_MATRICES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
             "w_down")


def _block_shapes(cfg: ModelConfig):
    hd, d, f = cfg.head_dim_, cfg.d_model, cfg.d_ff
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    attn = {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "wo": (nq, d)}
    if cfg.qkv_bias:
        attn.update(bq=(nq,), bk=(nkv,), bv=(nkv,))
    return {"norm1": {"scale": (d,)}, "attn": attn, "norm2": {"scale": (d,)},
            "ffn": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}}


def check_supported(cfg: ModelConfig):
    """The port runs the dense decoder as qwen2 configures it: RMSNorm,
    SwiGLU, rotate-half RoPE, tied embedding, full attention.  Anything
    else comes with its family (ROADMAP A12)."""
    unsupported = {
        "family": cfg.family != "dense", "num_experts": cfg.num_experts,
        "enc_layers": cfg.enc_layers, "norm": cfg.norm != "rmsnorm",
        "act": cfg.act != "silu", "parallel_block": cfg.parallel_block,
        "tie_embeddings": not cfg.tie_embeddings,
        "logit_softcap": cfg.logit_softcap,
        "sliding_window": cfg.sliding_window,
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

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return (x * (1.0 / fan_in ** 0.5)).to(dtype)

    def leaf(group, name, shape):
        if group.startswith("norm"):
            return torch.ones(shape, dtype=dtype, device=device)
        if name in ("bq", "bk", "bv"):
            return torch.zeros(shape, dtype=dtype, device=device)
        return normal(shape, L)  # stacked spec: fan_in = layers

    shapes = _block_shapes(cfg)
    blocks = [{grp: {nm: leaf(grp, nm, shp) for nm, shp in leaves.items()}
               for grp, leaves in shapes.items()} for _ in range(L)]
    v, d = cfg.padded_vocab, cfg.d_model
    return {"embed": normal((v, d), v),
            "final_norm": {"scale": torch.ones(d, dtype=dtype,
                                               device=device)},
            "blocks": blocks}


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
    return {"embed": t(tree["embed"]),
            "final_norm": {k: t(v) for k, v in tree["final_norm"].items()},
            "blocks": blocks}


def cast_for_compute(params, dtype) -> Dict[str, Any]:
    """A tree whose matrices, biases and embedding are already in the
    compute dtype, so no layer casts a weight per call.  Norm
    parameters stay as they are: the norms run in float32.  Casting
    once is numerically the same as the reference's cast at each use."""
    def blk(b):
        return {grp: {nm: (w.to(dtype) if nm in _MATRICES else w)
                      for nm, w in leaves.items()}
                for grp, leaves in b.items()}
    return {"embed": params["embed"].to(dtype),
            "final_norm": params["final_norm"],
            "blocks": [blk(b) for b in params["blocks"]]}
