"""Kernel dispatch and launch counters.

Each public function here routes by the device of its tensors: CUDA
tensors launch the hand-written kernel (``kernels/alloc_txn.py``,
``kernels/defrag_txn.py``, ``kernels/paged_attention.py``,
``kernels/ssd_scan.py``, ``kernels/ring_window.py``,
``kernels/bitmap_select.py``, which raise on anything the kernel does
not take), CPU tensors run the kernel's plain PyTorch version.  There
is no fallback from the card to the plain version.

The piecewise allocator's steps (``ring_txn_pop``, ``ring_txn_push``,
``chunk_txn_claim``, ``ring_window``, ``bitmap_select``) are reached
only from the core math's ``piecewise=True`` route; the transactions,
the facade and the serving engine never launch them.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launches`` zeroes the
counts before such a run).
"""
from __future__ import annotations

LAUNCHES = {"alloc_txn": 0, "free_txn": 0, "defrag_txn": 0,
            "sharded_alloc_txn": 0, "sharded_free_txn": 0,
            "sharded_defrag_txn": 0, "paged_attention": 0, "ssd_scan": 0,
            "ring_txn_pop": 0, "ring_txn_push": 0, "chunk_txn_claim": 0,
            "ring_window": 0, "bitmap_select": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def _on_cuda(t) -> bool:
    return t.device.type == "cuda"


def arena_alloc_txn(cfg, kind, family, mem, ctl, sizes_bytes, mask):
    """One whole alloc transaction, in place on ``mem``/``ctl``;
    returns the word offsets (−1 = failed lane)."""
    if _on_cuda(mem):
        from repro_torch.kernels import alloc_txn
        return alloc_txn.arena_alloc_txn(cfg, kind, family, mem, ctl,
                                         sizes_bytes, mask)
    from repro_torch.core.transactions import alloc_math
    return alloc_math(cfg, kind, family, mem, ctl, sizes_bytes, mask)[2]


def arena_free_txn(cfg, kind, family, mem, ctl, offsets_words, sizes_bytes,
                   mask):
    """One whole free transaction, in place on ``mem``/``ctl``."""
    if _on_cuda(mem):
        from repro_torch.kernels import alloc_txn
        alloc_txn.arena_free_txn(cfg, kind, family, mem, ctl, offsets_words,
                                 sizes_bytes, mask)
        return
    from repro_torch.core.transactions import free_math
    free_math(cfg, kind, family, mem, ctl, offsets_words, sizes_bytes, mask)


def arena_defrag_txn(cfg, kind, family, mem, ctl, src, dst, sizes):
    """One whole migration wave, in place on ``mem``/``ctl``."""
    if _on_cuda(mem):
        from repro_torch.kernels import defrag_txn
        defrag_txn.arena_defrag_txn(cfg, kind, family, mem, ctl, src, dst,
                                    sizes)
        return
    from repro_torch.core.defrag import migrate_math
    migrate_math(cfg, kind, family, mem, ctl, src, dst, sizes)


def sharded_arena_alloc_txn(cfg, num_shards, kind, family, mem, ctl,
                            sizes_bytes, mask, home, walk):
    """One whole sharded alloc transaction (the (walk+1, S) overflow-walk
    schedule), in place on ``mem``/``ctl`` (S, ·); returns the GLOBAL
    word offsets (−1 = failed lane)."""
    if _on_cuda(mem):
        from repro_torch.kernels import alloc_txn
        return alloc_txn.sharded_arena_alloc_txn(
            cfg, num_shards, kind, family, mem, ctl, sizes_bytes, mask,
            home, walk)
    from repro_torch.core.transactions import sharded_alloc_math
    return sharded_alloc_math(cfg, num_shards, kind, family, mem, ctl,
                              sizes_bytes, mask, home, walk)[2]


def sharded_arena_free_txn(cfg, num_shards, kind, family, mem, ctl,
                           offsets_words, sizes_bytes, mask):
    """One whole sharded free transaction, in place on ``mem``/``ctl``."""
    if _on_cuda(mem):
        from repro_torch.kernels import alloc_txn
        alloc_txn.sharded_arena_free_txn(cfg, num_shards, kind, family, mem,
                                         ctl, offsets_words, sizes_bytes,
                                         mask)
        return
    from repro_torch.core.transactions import sharded_free_math
    sharded_free_math(cfg, num_shards, kind, family, mem, ctl, offsets_words,
                      sizes_bytes, mask)


def sharded_arena_defrag_txn(cfg, num_shards, kind, family, mem, ctl, src,
                             dst, sizes):
    """One whole sharded migration wave (in-shard compaction or
    cross-shard rebalance), in place on ``mem``/``ctl``."""
    if _on_cuda(mem):
        from repro_torch.kernels import defrag_txn
        defrag_txn.sharded_arena_defrag_txn(cfg, num_shards, kind, family,
                                            mem, ctl, src, dst, sizes)
        return
    from repro_torch.core.defrag import sharded_migrate_math
    sharded_migrate_math(cfg, num_shards, kind, family, mem, ctl, src, dst,
                         sizes)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, wpp=None,
                    window=None, ring=False, k_scale=None, v_scale=None):
    """Paged GQA decode attention, (B, Hq, D) float32.  ``wpp`` set
    means ``page_table`` holds arena word offsets (page = offset // wpp);
    ``window`` keeps the last ``window`` tokens; ``ring`` reads the
    table as a ring (``kernels/ref.slot_tokens``); int8 pages come with
    their float32 scales (``k_scale``/``v_scale``, (NP, page, Hkv))."""
    kw = dict(wpp=wpp, window=window, ring=ring, k_scale=k_scale,
              v_scale=v_scale)
    if _on_cuda(q):
        from repro_torch.kernels import paged_attention as pa
        return pa.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                                  **kw)
    from repro_torch.kernels import ref
    return ref.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                               **kw)


def ssd_scan(x, dt, a, b, c, h0=None, *, chunk: int):
    """The Mamba-2 SSD chunked scan: ``(y (B, L, H, P), h_final (B, H, P,
    N))``, both float32.  The kernel takes L a multiple of ``chunk``; the
    plain version pads (callers pad first, so both paths see the same
    shapes)."""
    from repro_torch.kernels import ssd_scan as ssd
    if _on_cuda(x):
        return ssd.ssd_scan(x, dt, a, b, c, h0, chunk=chunk)
    return ssd.ssd_plain(x, dt, a, b, c, chunk, h0)


# ---- the piecewise allocator's steps ---------------------------------------

def ring_txn_pop(store, front, back, cls, valid, *, limit: bool):
    """Bulk pop of the class rings: ``(vals (n,), new front (C,))``."""
    if _on_cuda(store):
        from repro_torch.kernels import alloc_txn
        return alloc_txn.ring_txn_pop(store, front, back, cls, valid,
                                      limit=limit)
    from repro_torch.kernels import ref
    return ref.ring_txn_pop_ref(store, front, back, cls, valid, limit)


def ring_txn_push(store, back, cls, vals, valid):
    """Bulk push, in place on ``store``: ``(store, new back (C,))``."""
    if _on_cuda(store):
        from repro_torch.kernels import alloc_txn
        return alloc_txn.ring_txn_push(store, back, cls, vals, valid)
    from repro_torch.kernels import ref
    return ref.ring_txn_push_ref(store, back, cls, vals, valid)


def chunk_txn_claim(row, take, *, ppc: int):
    """Claim of one chunk's first ``take`` free pages:
    ``(page_idx (32 bw,), new row (bw,), claimed count (1,))``."""
    if _on_cuda(row):
        from repro_torch.kernels import alloc_txn
        return alloc_txn.chunk_txn_claim(row, take, ppc=ppc)
    from repro_torch.kernels import ref
    return ref.chunk_txn_claim_ref(row, take, ppc)


def ring_window(store, front, counts, *, m: int):
    """``out[c, j] = store[c, (front[c] + j) mod cap]`` for
    ``j < counts[c]``, else −1: (C, m)."""
    if _on_cuda(store):
        from repro_torch.kernels import ring_window as rw
        return rw.ring_window(store, front, counts, m=m)
    from repro_torch.kernels import ref
    return ref.ring_window_ref(store, front, counts, m)


def bitmap_select(words, k: int):
    """Dense rank map of the set bits of (W,) words: rank if below
    ``k``, else −1 (32 W,)."""
    if _on_cuda(words):
        from repro_torch.kernels import bitmap_select as bs
        return bs.bitmap_select(words, k)
    from repro_torch.kernels import ref
    return ref.bitmap_select_ref(words, k)


def bitmap_select_indices(words, k: int, *, max_k: int):
    """The first ``max_k`` entries of the ascending indices of the
    first ``k`` set bits, −1-padded, and their validity; each of length
    ``min(max_k, 32 W)``.  The rank map compacts in plain tensor code
    (a scatter by rank, no host read), as the reference compacts
    outside its kernel."""
    import torch
    dense = bitmap_select(words, k)
    L = min(max_k, dense.shape[0])
    slot = torch.where((dense >= 0) & (dense < L), dense.to(torch.int64),
                       torch.full_like(dense, L, dtype=torch.int64))
    idx = torch.full((L + 1,), -1, dtype=torch.int32, device=dense.device)
    idx.scatter_(0, slot, torch.arange(dense.shape[0], dtype=torch.int32,
                                       device=dense.device))
    return idx[:L], idx[:L] >= 0
