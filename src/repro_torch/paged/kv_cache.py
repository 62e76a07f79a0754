"""Paged KV cache backed by the Ouroboros allocator (port).

KV pages are allocated per sequence from an Ouroboros heap (variant
``vl_chunk``) and addressed through a page table.  Page heaps are
stacked over attention layers: one page id backs every layer's K/V
slots for its 16-token span.

The heaps are updated in place (``append1``/``prefill_write1`` write
into the layer views), since they are the largest state the server
owns.  A write through a table hole (−1) or past the table is dropped,
as in the reference; admission and the mega-step's failed slots rely
on that.  The writes keep fixed shapes and read nothing back to the
host, as does ``scatter_grant_words`` (the mega-step's grants into the
page table).  ``paged_attend1`` runs the paged attention kernel on the
card and its plain version on the CPU (``kernels/ops.paged_attention``).
A windowed model (mixtral's sliding window) writes and reads through
ring tables: table slot = page index mod P, so a table shorter than the
sequence recycles its slots, and attention sees only the last
``window`` tokens.

int8 heaps carry a float32 scale per (page, slot, kv head) beside the
words (``KVLayer.k_scale``/``v_scale``): each written row is quantized
over its head dim as the reference does (:func:`_quant`), and attention
reads ``k8 * k_scale`` (the same for V).

``forwarding_page_map``/``apply_forwarding`` carry a defragmentation
wave's forwarding table over to the KV heaps (and scales) and the page
table.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import HeapConfig, Ouroboros
from repro_torch.kernels import ops

PAGE_SIZE = 16  # tokens per KV page


class KVLayer(NamedTuple):
    """One attention layer's page heap (or the stack over layers)."""
    k: torch.Tensor  # (NP, page, Hkv, hd), or (L, NP, page, Hkv, hd)
    v: torch.Tensor
    # (NP, page, Hkv) float32, or (L, NP, page, Hkv): int8 heaps only
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class PagedKV(NamedTuple):
    layers: KVLayer            # stacked: (L, NP, page, Hkv, hd)
    page_table: torch.Tensor   # (B, P) int32, -1 = hole
    seq_lens: torch.Tensor     # (B,) int32, tokens already cached

    @property
    def page(self) -> int:
        return self.layers.k.shape[2]

    def layer(self, i: int) -> KVLayer:
        return KVLayer(*(None if t is None else t[i] for t in self.layers))


def init_paged_kv(num_layers: int, num_pages: int, batch: int,
                  max_pages_per_seq: int, num_kv_heads: int, head_dim: int,
                  kv_dtype=torch.bfloat16, page: int = PAGE_SIZE,
                  device="cpu") -> PagedKV:
    """Zero heaps; int8 heaps also get zero scales."""
    if kv_dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise TypeError(f"kv_dtype {kv_dtype} is not one of bfloat16, "
                        f"float32, int8")
    shape = (num_layers, num_pages, page, num_kv_heads, head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    quant = kv_dtype == torch.int8
    return PagedKV(
        layers=KVLayer(
            k=zeros(shape, kv_dtype), v=zeros(shape, kv_dtype),
            k_scale=zeros(shape[:4], torch.float32) if quant else None,
            v_scale=zeros(shape[:4], torch.float32) if quant else None),
        page_table=torch.full((batch, max_pages_per_seq), -1,
                              dtype=torch.int32, device=device),
        seq_lens=torch.zeros(batch, dtype=torch.int32, device=device))


def make_kv_allocator(num_pages: int, device="cuda", num_shards: int = 1):
    """Ouroboros instance managing the page-id space: each logical page
    is one 256-B region of a single-class heap of 4096-B chunks, so
    word offset // 64 ↔ page id.  Returns (ouro, words_per_page,
    physical_pages); size the KV heaps with ``physical_pages``, since
    vl queue segments occupy chunks of the same heap and make granted
    ids sparse in it.

    ``num_shards > 1`` partitions the page space into that many
    independent arenas, each sized for its share of the pages plus its
    own segment overhead; page ids stay global."""
    chunk = 4096
    pages_per_chunk = chunk // 256
    pages_per_shard = -(-num_pages // num_shards)
    data_chunks = -(-pages_per_shard // pages_per_chunk)
    # vl segments: one per size class (5) + chunk-queue chain growth
    # (1023 ids per segment) + headroom, per shard
    seg_chunks = 5 + data_chunks // 1023 + 3
    cfg = HeapConfig(
        total_bytes=num_shards * (data_chunks + seg_chunks) * chunk,
        chunk_bytes=chunk, min_page_bytes=256)
    physical_pages = cfg.total_words // 64
    return (Ouroboros(cfg, "vl_chunk", device=device,
                      num_shards=num_shards), 64, physical_pages)



def modality_page_quota(cfg, page_bytes: int = 256) -> int:
    """Arena pages of per-sequence state beyond the KV pages (the
    per-modality page policy): the serving engine grants this many pages
    to each slot at admission (``slot_aux``) and frees them at
    retirement, eviction or cancel, out of the same arena as the KV
    pages.

    - ``ssm`` (mamba2): per layer the SSD state, ``(nheads, headdim,
      state)`` float32, plus the ``(conv-1, conv_dim)`` bf16 conv tail;
    - ``moe`` (mixtral, phi3.5-moe): the routed expert activation
      buffers, ``top_k × d_ff`` bf16 per MoE layer;
    - dense: 0 (its per-sequence state is all KV pages).

    The hybrid quota (RG-LRU state) comes with its family (ROADMAP A12).

    >>> from repro_torch.configs import get_arch
    >>> modality_page_quota(get_arch("mamba2-780m"))
    298656
    >>> modality_page_quota(get_arch("mixtral-8x7b"))
    7168
    """
    if cfg.family == "ssm":
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        per_layer = (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
                     + (cfg.ssm_conv - 1) * conv_dim * 2)
        return -(-cfg.num_layers * per_layer // page_bytes)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid page quota comes with its family "
            f"(ROADMAP A12)")
    if cfg.num_experts:
        buf = cfg.num_layers * cfg.num_experts_per_tok * cfg.d_ff * 2
        return -(-buf // page_bytes)
    return 0


def _table_ids(page_table, pidx):
    """``page_table[b, pidx[b, j]]``; columns past the table read −1."""
    P = page_table.shape[1]
    ok = (pidx >= 0) & (pidx < P)
    ids = torch.gather(page_table, 1, torch.where(ok, pidx,
                                                  torch.zeros_like(pidx)))
    return torch.where(ok, ids, torch.full_like(ids, -1))


def _quant(x):
    """The reference's int8 quantization of float32 rows over the last
    axis: ``scale = max|x| / 127 + 1e-8``, words ``round(x / scale)``
    (half to even, as ``jnp.round``).  Returns (int8 words, scale
    (...,) float32)."""
    scale = x.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    return torch.round(x / scale).to(torch.int8), scale[..., 0]


def _store(layer: KVLayer, ids, slot, k_new, v_new):
    """Write rows where the page id is mapped; holes drop.  An int8
    layer stores the quantized rows and their scales.

    Fixed shapes, no host read: a dropped row repeats the first mapped
    row's write (its page, slot and value), or, when no row is mapped,
    writes page 0 slot 0's own value back.  Every index written twice
    then carries one value, so the words do not depend on the order of
    the writes."""
    np_ = layer.k.shape[0]
    ok = ((ids >= 0) & (ids < np_)).reshape(-1)
    if not ok.numel():
        return layer
    i, s = ids.reshape(-1).long(), slot.reshape(-1).long()
    # (1,) index tensors throughout: a 0-dim index would be read back
    first = torch.argmax(ok.to(torch.int32)).reshape(1)  # 0: none mapped
    any_ok = ok.index_select(0, first)
    zero = torch.zeros_like(first)
    i = torch.where(ok, i, torch.where(any_ok, i.index_select(0, first),
                                       zero))
    s = torch.where(ok, s, torch.where(any_ok, s.index_select(0, first),
                                       zero))
    writes = ((layer.k, k_new), (layer.v, v_new))
    if layer.k_scale is not None:
        kq, ks = _quant(k_new.float())
        vq, vs = _quant(v_new.float())
        writes = ((layer.k, kq), (layer.v, vq), (layer.k_scale, ks),
                  (layer.v_scale, vs))
    for heap, new in writes:
        new = new.reshape((-1,) + tuple(heap.shape[2:])).to(heap.dtype)
        row = (-1,) + (1,) * (new.dim() - 1)   # a row flag over its values
        keep = torch.where(any_ok.view(row), new.index_select(0, first),
                           heap[0, 0][None])
        heap[i, s] = torch.where(ok.view(row), new, keep)
    return layer


def _page_index(pos, page: int, P: int, ring: bool):
    """Table slot of token position ``pos``: its page index, mod P in a
    ring table."""
    pidx = pos // page
    return pidx % P if ring and P else pidx


def append1(layer: KVLayer, page_table, seq_lens, k_t, v_t,
            ring: bool = False) -> KVLayer:
    """Write one new token's K/V at position ``seq_lens`` per sequence
    (in place).  k_t, v_t: (B, 1, Hkv, hd).  ``ring``: table slot = page
    index mod P (windowed attention)."""
    page = layer.k.shape[1]
    pos = seq_lens.to(torch.int64)[:, None]
    ids = _table_ids(page_table, _page_index(pos, page, page_table.shape[1],
                                             ring))
    return _store(layer, ids, pos % page, k_t, v_t)


def prefill_write1(layer: KVLayer, page_table, k, v, pos0: int = 0,
                   ring: bool = False) -> KVLayer:
    """Bulk-write a prefill segment (in place).  k, v: (B, S, Hkv, hd).
    ``ring`` as in :func:`append1`."""
    B, S = k.shape[:2]
    page = layer.k.shape[1]
    pos = (pos0 + torch.arange(S, device=k.device))[None, :].expand(B, S)
    ids = _table_ids(page_table, _page_index(pos, page, page_table.shape[1],
                                             ring))
    return _store(layer, ids, pos % page, k, v)


def scatter_grant_words(page_table, page_counts, lane_slot, lane_rank,
                        lane_offs, grant_ok, wpp: int):
    """Scatter granted arena WORD offsets into the page table, in place
    (the mega-step's path: grants go kernel → page id ``offset // wpp``
    → table without a host read).  Lane ``j`` lands at row
    ``lane_slot[j]``, column ``page_counts[slot] + lane_rank[j]``; lanes
    with ``grant_ok[j]`` False, and columns past the table, are dropped.
    Fixed shapes: each entry compares against every lane and takes the
    page of the one that hits it (granted lanes hit distinct entries).
    Returns ``page_table``.

    >>> import torch
    >>> pt = torch.full((2, 3), -1, dtype=torch.int32)
    >>> _ = scatter_grant_words(
    ...     pt, torch.tensor([1, 0]),                   # pages mapped
    ...     torch.tensor([0, 1]), torch.tensor([0, 0]),  # lane slot, rank
    ...     torch.tensor([128, 0]),                     # granted words
    ...     torch.tensor([True, True]), wpp=64)
    >>> pt.tolist()
    [[-1, 2, -1], [0, -1, -1]]
    """
    B, P = page_table.shape
    dev = page_table.device
    col = page_counts.long()[lane_slot.long()] + lane_rank.long()
    rows = torch.arange(B, device=dev)[:, None, None]
    cols = torch.arange(P, device=dev)[None, :, None]
    hit = (grant_ok[None, None, :] & (lane_slot.long()[None, None, :] == rows)
           & (col[None, None, :] == cols))
    pages = torch.div(lane_offs, wpp, rounding_mode="floor").to(torch.int32)
    new = torch.where(hit, pages[None, None, :],
                      torch.zeros_like(pages)[None, None, :]).sum(-1)
    page_table.copy_(torch.where(hit.any(-1), new.to(torch.int32),
                                 page_table))
    return page_table


def forwarding_page_map(fwd, wpp: int, max_span: int):
    """Expand a defrag :class:`~repro_torch.core.defrag.Forwarding`
    table to page granularity: ``(src_pids, dst_pids)`` int32 (−1
    padded), one entry per migrated page.  ``max_span`` bounds pages
    per extent (the allocator's ``words_per_chunk // wpp``)."""
    k = fwd.sizes // (wpp * 4)
    j = torch.arange(max_span, dtype=torch.int32,
                     device=fwd.src.device)[None, :]
    ok = (fwd.src >= 0)[:, None] & (j < k[:, None])
    neg = torch.full_like(j, -1)
    sp = torch.where(ok, fwd.src[:, None] // wpp + j, neg)
    dp = torch.where(ok, fwd.dst[:, None] // wpp + j, neg)
    return sp.reshape(-1).to(torch.int32), dp.reshape(-1).to(torch.int32)


def apply_forwarding(kv: PagedKV, fwd, wpp: int,
                     max_span: Optional[int] = None) -> PagedKV:
    """Apply a defrag forwarding table to the paged cache, in place:
    move the migrated pages' K/V rows (and int8 scales) of every layer
    to their new page ids and rewrite every matching page-table entry,
    after which reads through the table are identical to those before
    the wave.  Sources and destinations are disjoint (the planner's
    guarantee).  Returns ``kv`` (the same tensors).  ``max_span``
    defaults to the table's widest extent."""
    if max_span is None:
        max_span = max(1, int((fwd.sizes // (wpp * 4)).max()))
    sp, dp = forwarding_page_map(fwd, wpp, max_span)
    moved = sp >= 0
    np_ = kv.layers.k.shape[1]
    rows = moved & (dp < np_)          # as the reference: writes past drop
    s = torch.clamp(sp[rows].long(), max=np_ - 1)
    d = dp[rows].long()
    for heap in kv.layers:
        if heap is not None:
            heap[:, d] = heap[:, s]
    key = torch.where(moved, sp, torch.full_like(sp, -2))
    hit = kv.page_table[:, :, None] == key[None, None, :]
    new = torch.where(hit, dp[None, None, :],
                      torch.zeros_like(dp)[None, None, :]).sum(-1)
    kv.page_table.copy_(torch.where(hit.any(-1), new.to(torch.int32),
                                    kv.page_table))
    return kv


def paged_attend1(layer: KVLayer, page_table, kv_len, q, wpp=None, *,
                  window: Optional[int] = None, ring: bool = False):
    """Decode attention for one layer over the paged heap.
    q: (B, 1, Hq, hd); kv_len: (B,) valid tokens (incl. current).
    ``window``: only the last ``window`` tokens are seen; ``ring``: the
    table is a ring (slot j holds the page of the ring's last lap).
    Returns (B, 1, Hq, hd) float32."""
    out = ops.paged_attention(q[:, 0].contiguous(), layer.k, layer.v,
                              page_table, kv_len.to(torch.int32), wpp=wpp,
                              window=window, ring=ring,
                              k_scale=layer.k_scale, v_scale=layer.v_scale)
    return out[:, None]
