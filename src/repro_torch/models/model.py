"""Public model facade (port): dense and MoE decoders (the VLM too), the
Mamba-2 family, the hybrid (RG-LRU + local attention) family and the
encoder-decoder:

    m = build_model(get_arch("qwen2-0.5b"))
    params = m.init(seed, device="cuda")
    caches = m.make_decode_caches(batch=8, max_seq=512, device="cuda")
    logits, caches = m.prefill(params, {"tokens": tokens}, caches)
    logits, caches = m.decode_step(params, tokens, caches)

Caches are updated in place (KV heaps and ``seq_lens``; the SSM states)
and returned.  An attention-free model (``ssm``) carries no KV: its
caches are the per-layer SSD state and conv tail, and ``prefill`` with
``Caches()`` returns them freshly stacked.  A hybrid model carries both:
KV pages for its attention layers, and each recurrent layer's RG-LRU
state and conv tail.  An encoder-decoder's caches are
:class:`encdec.EncDecCaches`: the decoder's paged self-attention KV and
the dense cross-attention K/V with each row's valid encoder length.

Batches are dicts: ``{"tokens"}``, with the VLM's optional
``"mm_embeds"`` (B, S, d) and ``"positions"`` ((B, S), or (B, 3, S)
for M-RoPE); an encoder-decoder's ``{"src_embeds" (B, Se, d),
"src_valid" (B,), "tokens"}``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import params as Prm
from repro_torch.models import rglru as Rgl
from repro_torch.models import ssm as Ssm
from repro_torch.models import transformer as TF
from repro_torch.paged import kv_cache as KV


def kv_dtype_for(cfg: ModelConfig, seq_len: int, batch: int):
    """The reference's rule for the KV page type: int8 pages when the
    bf16 K and V of every attention layer at ``batch`` x ``seq_len``
    tokens would pass 2.5e12 bytes (qwen1.5-32b at 64 x 32,768), else
    bf16.  An encoder-decoder counts its decoder layers twice (self and
    cross K/V), as the reference does, though only the self K/V is
    paged.

    >>> from repro_torch.configs import get_arch
    >>> kv_dtype_for(get_arch("qwen1.5-32b"), 32768, 64)
    torch.int8
    >>> kv_dtype_for(get_arch("qwen1.5-32b"), 1024, 8)
    torch.bfloat16
    """
    layers = TF.num_attn_layers(cfg) + (cfg.num_layers if cfg.is_encdec
                                        else 0)
    bytes_bf16 = (2 * layers * batch * seq_len * cfg.num_kv_heads
                  * cfg.head_dim_ * 2)
    return torch.int8 if bytes_bf16 > 2.5e12 else torch.bfloat16


def kv_of(cfg: ModelConfig, caches):
    """The paged KV of ``caches`` (None for an attention-free model):
    an encoder-decoder's is its decoder's self-attention KV."""
    return caches.self_kv if cfg.is_encdec else caches.kv


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        Prm.check_supported(self.cfg)

    def init(self, seed: int = 0, device="cuda", dtype=torch.float32):
        """Random parameters from ``seed`` (float32 masters, as the
        reference's ``init``; ``dtype=torch.bfloat16`` casts each leaf
        as it is drawn, for a model whose float32 tree does not fit)."""
        return Prm.init(self.cfg, seed, resolve_device(device), dtype)

    def make_decode_caches(self, batch: int, max_seq: int, kv_dtype=None,
                           num_pages: Optional[int] = None, device="cuda"):
        """Paged KV for the attention layers, in ``kv_dtype`` (None: as
        :func:`kv_dtype_for` picks; int8 pages carry their scales); for
        the recurrent layers, zero states (float32: the ssm family's SSD
        state (H, P, N), the hybrid's RG-LRU state (R,)) and conv tails.
        The conv tail is bf16, or float32 with float32 KV: the reference
        keeps it in bf16 whatever the KV type, and its float32 engines
        promote it to float32 at the first row merge.  An
        encoder-decoder gets paged KV for its decoder's self-attention
        and zero cross K/V for an encoder of ``max_seq`` frames (the
        serving engine's fixed encoder length), in the same type as the
        conv tail (the compute type of every engine: bf16, float32 with
        float32 KV), with every row's valid length 0."""
        cfg = self.cfg
        dev = resolve_device(device)
        kv_dtype = kv_dtype or kv_dtype_for(cfg, max_seq, batch)
        page = KV.PAGE_SIZE
        pps = -(-max_seq // page)
        n_attn, n_rec = TF.num_attn_layers(cfg), TF.num_rec_layers(cfg)
        wide = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
        kv = ssm_h = ssm_conv = None
        if n_attn:
            kv = KV.init_paged_kv(
                n_attn, num_pages or batch * pps, batch, pps,
                cfg.num_kv_heads, cfg.head_dim_, kv_dtype, page, device=dev)
        if cfg.is_encdec:
            shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                     cfg.head_dim_)
            cross = [torch.zeros(shape, dtype=wide, device=dev)
                     for _ in range(2)]
            return ED.EncDecCaches(
                self_kv=kv, cross_k=cross[0], cross_v=cross[1],
                enc_valid=torch.zeros(batch, dtype=torch.int32, device=dev))
        if n_rec:
            if cfg.family == "hybrid":
                r = cfg.lru_width or cfg.d_model
                h_shape = (n_rec, batch, r)
                c_shape = (n_rec, batch, Rgl.CONV_WIDTH - 1, r)
            else:
                h_shape = (n_rec, batch, cfg.ssm_nheads, cfg.ssm_headdim,
                           cfg.ssm_state)
                c_shape = (n_rec, batch, cfg.ssm_conv - 1,
                           Ssm.conv_dim(cfg))
            ssm_h = torch.zeros(h_shape, dtype=torch.float32, device=dev)
            ssm_conv = torch.zeros(c_shape, dtype=wide, device=dev)
        return TF.Caches(kv=kv, ssm_h=ssm_h, ssm_conv=ssm_conv)

    def prefill(self, params, batch, caches, dtype=torch.bfloat16):
        """Full-sequence pass that writes the decode caches.  Returns
        (last-position logits (B, V_pad) float32, caches with
        ``seq_lens`` advanced by the prompt length).  An
        encoder-decoder encodes ``src_embeds`` first and takes
        ``enc_valid`` from ``src_valid`` (written into the caches' own
        tensor when they hold one)."""
        tokens = batch["tokens"]
        if self.cfg.is_encdec:
            enc = ED.encode(self.cfg, params, batch["src_embeds"], dtype)
            valid = batch.get("src_valid")
            if valid is not None and caches.enc_valid is not None:
                caches.enc_valid.copy_(valid)
            else:
                caches = caches._replace(enc_valid=valid)
            logits, caches = ED.decode_stack(self.cfg, params, tokens, enc,
                                             "prefill", caches, dtype)
        else:
            logits, caches = TF.forward(self.cfg, params, tokens,
                                        positions=batch.get("positions"),
                                        extra_embeds=batch.get("mm_embeds"),
                                        mode="prefill", caches=caches,
                                        dtype=dtype)
        kv = kv_of(self.cfg, caches)
        if kv is not None:
            kv.seq_lens.add_(tokens.shape[1])
        return logits[:, -1], caches

    def decode_step(self, params, tokens, caches, dtype=torch.bfloat16,
                    advance=None):
        """One token per sequence.  tokens: (B, 1).  Returns (logits
        (B, V_pad) float32, caches with every ``seq_lens`` advanced).
        ``advance`` (B,) bool advances only those rows' ``seq_lens`` and
        recurrent states (the mega-step's masked advance: a row left out
        must also have its K/V write land in a table hole, where it
        drops).  An attention-free model's rows always advance: it has
        no grant that can fail, and an idle row is rewritten at
        admission.  An encoder-decoder reads its cross K/V and leaves
        it as it is."""
        kv = kv_of(self.cfg, caches)
        if self.cfg.is_encdec:
            logits, caches = ED.decode_stack(self.cfg, params, tokens, None,
                                             "decode", caches, dtype)
        else:
            rows = advance if kv is not None else None
            logits, caches = TF.forward(self.cfg, params, tokens,
                                        mode="decode", caches=caches,
                                        dtype=dtype, rows=rows)
        if kv is not None:
            kv.seq_lens.add_(1 if advance is None
                             else advance.to(torch.int32))
        return logits[:, 0], caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
