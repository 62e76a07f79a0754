"""Parameters of the dense and MoE decoders, the Mamba-2 stack, the
hybrid (RG-LRU + local attention) stack and the encoder-decoder (port):
init from a seed, and the converters from the reference's parameter
tree and from its serving engine's snapshots.

The port's tree mirrors the reference's names with the layer axis
unstacked into a list::

    {"embed": (V_pad, d), "final_norm": {"scale": (d,)},
     "blocks": [{"norm1": {"scale"}, "attn": {"wq", "wk", "wv", "wo",
                 "bq", "bk", "bv"}, "norm2": {"scale"},
                 "ffn": {"w_gate", "w_up", "w_down"}}, ...],
     "lm_head": (d, V_pad)}     # only when embeddings are untied

where a parallel block (command-r) has no ``norm2``, a MoE block's
``ffn`` is ``{"router" (d, E), "w_gate" (E, d, f),
"w_up" (E, d, f), "w_down" (E, f, d)}``, and an ssm block is
``{"norm": {"scale"}, "mixer": {"in_proj", "conv_w", "conv_b", "a_log",
"dt_bias", "d_skip", "norm_scale", "out_proj"}}``.  A hybrid model has
no ``blocks``: ``triples`` is a list of ``{"rec1", "rec2", "attn"}``
(num_layers // 3 of them) and ``tail`` a list of the num_layers % 3
recurrent blocks after them, where a recurrent block is ``{"norm1",
"mixer": {"w_gate_branch", "w_rec_branch", "conv_w", "conv_b",
"w_input_gate", "w_rec_gate", "lambda_p", "w_out"}, "norm2", "ffn"}``
and ``attn`` a dense block.  An encoder-decoder has no ``blocks``
either: ``enc_in`` (d, d), ``enc_blocks`` (enc_layers dense blocks),
``enc_norm``, and ``dec_blocks`` (num_layers blocks that add
``norm_x`` and a cross-attention ``xattn`` of the same leaves as
``attn``).  With ``norm="layernorm"`` every norm group is ``{"scale",
"bias"}``.

Matrices keep the reference's ``x @ W`` layout, W as (d_in, d_out), and
attention heads stay merged.  :func:`init` draws the same shapes and
distributions as the reference ``Model.init``: a normal leaf has
std = scale/sqrt(shape[0]) of its *stacked* spec, so every block matrix
(the router and the experts too) has std 1/sqrt(num_layers) (``conv_w``
1/sqrt(ssm_conv * num_layers)); a hybrid's are stacked by triple and by
tail, so 1/sqrt(num_layers // 3) and 1/sqrt(num_layers % 3) (``conv_w``
half that); an encoder-decoder's by stack, 1/sqrt(enc_layers) and
1/sqrt(num_layers); the embedding 1/sqrt(V_pad), ``enc_in`` and
``lm_head`` 1/sqrt(d); norm scales, ``d_skip`` and ``norm_scale`` are
ones, biases (``conv_b`` and the LayerNorms' too) zeros, ``a_log`` the constant log 4, ``dt_bias`` the constant -3
and ``lambda_p`` the constant 1.  Each leaf is drawn in float32 and
cast to ``dtype`` at once, layer by layer (every leaf of block 0, then
block 1, ..., then ``embed`` and ``lm_head``), so a bf16 init holds the
bf16 tree plus one float32 leaf: for qwen1.5-32b's 70.4 GB of bf16
weights, at most its 3.1-GB float32 embedding (a layer's largest leaf,
an MLP matrix, is 0.56 GB), where drawing each stacked (64, 5120, 27392)
leaf whole would take 35.9 GB at once.  The leaves the reference
multiplies in float32 (the RG-LRU's ``w_input_gate``, ``w_rec_gate``
and ``lambda_p``) stay float32 at any ``dtype``.  The numbers differ
from the reference's (a ``torch.Generator``, not a JAX key); tests that
need the same numbers convert the reference's tree with
:func:`params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as Moe
from repro_torch.models import rglru as Rgl
from repro_torch.models import ssm as Ssm

# leaves multiplied into activations: cast to the compute dtype once
_MATRICES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
             "w_down", "in_proj", "conv_w", "conv_b", "out_proj", "router",
             "w_gate_branch", "w_rec_branch", "w_out", "embed", "lm_head",
             "enc_in")
# leaves the reference multiplies in float32: never cast down
_FLOAT32 = ("w_input_gate", "w_rec_gate", "lambda_p")


def _norm_shapes(cfg: ModelConfig):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": (d,), "bias": (d,)}
    return {"scale": (d,)}


def _attn_shapes(cfg: ModelConfig):
    hd, d = cfg.head_dim_, cfg.d_model
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    attn = {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "wo": (nq, d)}
    if cfg.qkv_bias:
        attn.update(bq=(nq,), bk=(nkv,), bv=(nkv,))
    return attn


def _block_shapes(cfg: ModelConfig):
    if cfg.family == "ssm":
        return {"norm": _norm_shapes(cfg), "mixer": Ssm.ssm_shapes(cfg)}
    d, f = cfg.d_model, cfg.d_ff
    ffn = (Moe.moe_shapes(cfg) if cfg.num_experts else
           {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    out = {"norm1": _norm_shapes(cfg), "attn": _attn_shapes(cfg),
           "ffn": ffn}
    if not cfg.parallel_block:   # a parallel block has one norm
        out["norm2"] = _norm_shapes(cfg)
    return out


def _dec_shapes(cfg: ModelConfig):
    """An encoder-decoder's decoder block: self-attention, then
    cross-attention behind ``norm_x``, then the MLP."""
    return {**_block_shapes(cfg), "norm_x": _norm_shapes(cfg),
            "xattn": _attn_shapes(cfg)}


def _rec_shapes(cfg: ModelConfig):
    """A hybrid's recurrent block: RG-LRU mixer and gated MLP."""
    d, f = cfg.d_model, cfg.d_ff
    return {"norm1": _norm_shapes(cfg), "mixer": Rgl.rglru_shapes(cfg),
            "norm2": _norm_shapes(cfg),
            "ffn": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}}


def hybrid_counts(cfg: ModelConfig):
    """(triples, tail blocks) of a hybrid stack."""
    return divmod(cfg.num_layers, cfg.attn_period)


def check_supported(cfg: ModelConfig):
    """The port runs the dense decoder as qwen2 and qwen2-vl configure
    it (RMSNorm, SwiGLU, rotate-half RoPE or M-RoPE), the MoE decoder
    as mixtral and phi3.5-moe configure it (top-k experts, a sliding
    window, an untied ``lm_head``), the Mamba-2 stack as mamba2
    configures it, the hybrid stack as recurrentgemma configures it
    (RG-LRU and local attention in (rec, rec, attn) triples, GeGLU) and
    the encoder-decoder as seamless-m4t configures it (LayerNorm,
    GeGLU, cross-attention), and command-r's parallel block (attention
    and FFN from one norm, summed).  No reference config sets
    ``logit_softcap``, so it stays refused."""
    unsupported = {
        "family": cfg.family not in ("dense", "moe", "ssm", "hybrid",
                                     "encdec"),
        "num_experts": bool(cfg.num_experts) != (cfg.family == "moe"),
        "enc_layers": bool(cfg.enc_layers) != (cfg.family == "encdec"),
        "norm": cfg.norm not in ("rmsnorm", "layernorm"),
        "act": cfg.act not in ("silu", "gelu"),
        # a triple is (rec, rec, attn), as the reference lays it out
        "attn_period": cfg.family == "hybrid" and cfg.attn_period != 3,
        "parallel_block": (cfg.parallel_block
                           and cfg.family not in ("dense", "moe")),
        "logit_softcap": cfg.logit_softcap}
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(f"{cfg.name}: {bad} not ported")


def init(cfg: ModelConfig, seed: int, device="cpu",
         dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters from ``seed`` with the reference's shapes and
    distributions (see module docstring)."""
    check_supported(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def normal(shape, fan_in, scale=1.0, dt=dtype):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        # scaled in place: one float32 copy of the leaf at a time (8.4
        # GB for command-r's 256,000 x 8192 embedding), the same values
        return x.mul_(scale / fan_in ** 0.5).to(dt)

    def leaf(group, name, shape, stacked):
        """``stacked``: the leading dimension of the leaf's stacked spec,
        its fan-in."""
        dt = torch.float32 if name in _FLOAT32 else dtype
        if name in ("bq", "bk", "bv", "conv_b", "bias"):
            return torch.zeros(shape, dtype=dt, device=device)
        if group.startswith("norm") or name in ("d_skip", "norm_scale"):
            return torch.ones(shape, dtype=dt, device=device)
        if name in ("a_log", "dt_bias", "lambda_p"):
            c = {"a_log": math.log(4.0), "dt_bias": -3.0, "lambda_p": 1.0}
            return torch.full(shape, c[name], dtype=dt, device=device)
        width = Rgl.CONV_WIDTH if cfg.family == "hybrid" else cfg.ssm_conv
        scale = 1.0 / math.sqrt(width) if name == "conv_w" else 1.0
        return normal(shape, stacked, scale, dt)

    def block(shapes, stacked):
        return {grp: {nm: leaf(grp, nm, shp, stacked)
                      for nm, shp in leaves.items()}
                for grp, leaves in shapes.items()}

    def norm():
        return {nm: leaf("norm", nm, shp, 1)
                for nm, shp in _norm_shapes(cfg).items()}

    out = {}
    v, d = cfg.padded_vocab, cfg.d_model
    if cfg.family == "hybrid":
        ntri, tail = hybrid_counts(cfg)
        rec, attn = _rec_shapes(cfg), _block_shapes(cfg)
        out["triples"] = [{"rec1": block(rec, ntri), "rec2": block(rec, ntri),
                           "attn": block(attn, ntri)} for _ in range(ntri)]
        out["tail"] = [block(rec, tail) for _ in range(tail)]
    elif cfg.is_encdec:
        enc, dec = _block_shapes(cfg), _dec_shapes(cfg)
        out["enc_blocks"] = [block(enc, cfg.enc_layers)
                             for _ in range(cfg.enc_layers)]
        out["dec_blocks"] = [block(dec, cfg.num_layers)
                             for _ in range(cfg.num_layers)]
        out["enc_in"] = normal((d, d), d)
        out["enc_norm"] = norm()
    else:
        shapes = _block_shapes(cfg)
        out["blocks"] = [block(shapes, cfg.num_layers)
                         for _ in range(cfg.num_layers)]
    out["embed"] = normal((v, d), v)
    out["final_norm"] = norm()
    if not cfg.tie_embeddings:
        out["lm_head"] = normal((d, v), d)
    return out


def params_from_jax(cfg: ModelConfig, tree, device="cpu") -> Dict[str, Any]:
    """Convert the reference ``Model.init`` tree, given as numpy arrays
    (``blocks``, ``triples``, ``tail``, ``enc_blocks`` and
    ``dec_blocks`` stacked over their layers), into the port's tree."""
    check_supported(cfg)

    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    def unstack(sub, i):
        return {k: (unstack(v, i) if isinstance(v, dict)
                    else t(np.asarray(v)[i])) for k, v in sub.items()}

    def layers(name, n):
        return [unstack(tree[name], i) for i in range(n)]

    out = {}
    if cfg.family == "hybrid":
        ntri, tail = hybrid_counts(cfg)
        out["triples"] = layers("triples", ntri)
        out["tail"] = layers("tail", tail) if tail else []
    elif cfg.is_encdec:
        out["enc_blocks"] = layers("enc_blocks", cfg.enc_layers)
        out["dec_blocks"] = layers("dec_blocks", cfg.num_layers)
        out["enc_in"] = t(tree["enc_in"])
        out["enc_norm"] = {k: t(v) for k, v in tree["enc_norm"].items()}
    else:
        out["blocks"] = layers("blocks", cfg.num_layers)
    out["embed"] = t(tree["embed"])
    out["final_norm"] = {k: t(v) for k, v in tree["final_norm"].items()}
    if not cfg.tie_embeddings:
        out["lm_head"] = t(tree["lm_head"])
    return out


def snapshot_from_jax(snap, device="cpu") -> Dict[str, Any]:
    """Convert the reference engine's in-memory snapshot (``{"tree",
    "meta"}``, numpy leaves, bfloat16 as ``ml_dtypes`` arrays, in the
    reference's dicts and NamedTuples) into the port's: every leaf a
    tensor on ``device``, every NamedTuple the port's of the same name.
    ``ServingEngine.restore`` of the result continues the reference's
    streams; a port snapshot goes the other way through its key paths
    (``ckpt.checkpoint.flatten`` gives the reference's keys), as a
    checkpoint directory does."""
    import json
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.models.encdec import EncDecCaches
    from repro_torch.models.transformer import Caches
    from repro_torch.paged.kv_cache import KVLayer, PagedKV
    from repro_torch.serve.engine import MegaState
    types = {t.__name__: t for t in (Caches, EncDecCaches, KVLayer,
                                     PagedKV, MegaState)}

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            name = type(x).__name__
            if name not in types:
                raise TypeError(f"no port counterpart of {name}")
            return types[name](*(conv(v) for v in x))
        return CK.as_tensor(np.asarray(x)).to(device)

    return {"tree": conv(snap["tree"]),
            "meta": json.loads(json.dumps(snap["meta"]))}


def cast_for_compute(params, dtype) -> Dict[str, Any]:
    """A tree whose matrices, biases and embedding are already in the
    compute dtype, so no layer casts a weight per call.  Norm
    parameters stay as they are: the norms run in float32; so do the
    RG-LRU's float32 leaves.  Casting once is numerically the same as
    the reference's cast at each use."""
    def cast(x, name=None):
        if isinstance(x, dict):
            return {k: cast(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        return x.to(dtype) if name in _MATRICES else x
    return cast(params)
