"""Paged KV cache backed by the Ouroboros allocator (port).

KV pages are allocated per sequence from an Ouroboros heap (variant
``vl_chunk``) and addressed through a page table.  Page heaps are
stacked over attention layers: one page id backs every layer's K/V
slots for its 16-token span.

The heaps are updated in place (``append1``/``prefill_write1`` write
into the layer views), since they are the largest state the server
owns.  A write through a table hole (−1) or past the table is dropped,
as in the reference; admission relies on that.  ``paged_attend1`` runs
the paged attention kernel on the card and its plain version on the
CPU (``kernels/ops.paged_attention``).

Ported so far: bf16/float32 caches.  int8 pages with per-(slot, head)
scales, ``window`` and ``ring`` tables are ROADMAP item A6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import HeapConfig, Ouroboros
from repro_torch.kernels import ops

PAGE_SIZE = 16  # tokens per KV page


class KVLayer(NamedTuple):
    """One attention layer's page heap (or the stack over layers)."""
    k: torch.Tensor  # (NP, page, Hkv, hd), or (L, NP, page, Hkv, hd)
    v: torch.Tensor


class PagedKV(NamedTuple):
    layers: KVLayer            # stacked: (L, NP, page, Hkv, hd)
    page_table: torch.Tensor   # (B, P) int32, -1 = hole
    seq_lens: torch.Tensor     # (B,) int32, tokens already cached

    @property
    def page(self) -> int:
        return self.layers.k.shape[2]

    def layer(self, i: int) -> KVLayer:
        return KVLayer(self.layers.k[i], self.layers.v[i])


def init_paged_kv(num_layers: int, num_pages: int, batch: int,
                  max_pages_per_seq: int, num_kv_heads: int, head_dim: int,
                  kv_dtype=torch.bfloat16, page: int = PAGE_SIZE,
                  device="cpu") -> PagedKV:
    if kv_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"kv_dtype {kv_dtype} is not ported yet (int8 pages: ROADMAP A6)")
    shape = (num_layers, num_pages, page, num_kv_heads, head_dim)
    return PagedKV(
        layers=KVLayer(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                       v=torch.zeros(shape, dtype=kv_dtype, device=device)),
        page_table=torch.full((batch, max_pages_per_seq), -1,
                              dtype=torch.int32, device=device),
        seq_lens=torch.zeros(batch, dtype=torch.int32, device=device))


def make_kv_allocator(num_pages: int, device="cuda"):
    """Ouroboros instance managing the page-id space: each logical page
    is one 256-B region of a single-class heap of 4096-B chunks, so
    word offset // 64 ↔ page id.  Returns (ouro, words_per_page,
    physical_pages); size the KV heaps with ``physical_pages``, since
    vl queue segments occupy chunks of the same heap and make granted
    ids sparse in it."""
    chunk = 4096
    pages_per_chunk = chunk // 256
    data_chunks = -(-num_pages // pages_per_chunk)
    # vl segments: one per size class (5) + chunk-queue chain growth
    # (1023 ids per segment) + headroom
    seg_chunks = 5 + data_chunks // 1023 + 3
    cfg = HeapConfig(total_bytes=(data_chunks + seg_chunks) * chunk,
                     chunk_bytes=chunk, min_page_bytes=256)
    physical_pages = cfg.total_words // 64
    return Ouroboros(cfg, "vl_chunk", device=device), 64, physical_pages


def _table_ids(page_table, pidx):
    """``page_table[b, pidx[b, j]]``; columns past the table read −1."""
    P = page_table.shape[1]
    ok = (pidx >= 0) & (pidx < P)
    ids = torch.gather(page_table, 1, torch.where(ok, pidx,
                                                  torch.zeros_like(pidx)))
    return torch.where(ok, ids, torch.full_like(ids, -1))


def _store(layer: KVLayer, ids, slot, k_new, v_new):
    """Write rows where the page id is mapped; holes drop."""
    np_ = layer.k.shape[0]
    ok = (ids >= 0) & (ids < np_)
    i, s = ids[ok].long(), slot[ok].long()
    layer.k[i, s] = k_new[ok].to(layer.k.dtype)
    layer.v[i, s] = v_new[ok].to(layer.v.dtype)
    return layer


def append1(layer: KVLayer, page_table, seq_lens, k_t, v_t) -> KVLayer:
    """Write one new token's K/V at position ``seq_lens`` per sequence
    (in place).  k_t, v_t: (B, 1, Hkv, hd)."""
    page = layer.k.shape[1]
    pos = seq_lens.to(torch.int64)[:, None]
    ids = _table_ids(page_table, pos // page)
    return _store(layer, ids, pos % page, k_t, v_t)


def prefill_write1(layer: KVLayer, page_table, k, v, pos0: int = 0
                   ) -> KVLayer:
    """Bulk-write a prefill segment (in place).  k, v: (B, S, Hkv, hd)."""
    B, S = k.shape[:2]
    page = layer.k.shape[1]
    pos = (pos0 + torch.arange(S, device=k.device))[None, :].expand(B, S)
    ids = _table_ids(page_table, pos // page)
    return _store(layer, ids, pos % page, k, v)


def paged_attend1(layer: KVLayer, page_table, kv_len, q, wpp=None):
    """Decode attention for one layer over the paged heap.
    q: (B, 1, Hq, hd); kv_len: (B,) valid tokens (incl. current).
    Returns (B, 1, Hq, hd) float32."""
    out = ops.paged_attention(q[:, 0].contiguous(), layer.k, layer.v,
                              page_table, kv_len.to(torch.int32), wpp=wpp)
    return out[:, None]
