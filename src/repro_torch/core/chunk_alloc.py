"""Chunk allocator (paper §4.2, fig. 2) over the vl queue family: the
plain PyTorch transaction math.

Queues hold chunk ids; every chunk carries a page-occupancy bitmap.
``alloc`` serves each size class in turn: it pops a chunk from the
class queue (or claims a fresh one from the pool), claims the first
free bits of its bitmap, and re-enqueues the chunk if pages remain.
``free`` clears bits and re-enqueues chunks on their full → non-full
transition, in ascending chunk-id order.

This is the plain version of the CUDA transaction kernels
(``csrc/alloc_txn.cu``): the CPU path and the parity tests run it.  It
updates the arena views in place.  The chunk-drain loop is a Python
loop whose control scalars are read back with ``int()``; the kernel
drives the same chain with one thread and no host reads.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import groups, queues
from repro_torch.core._index import gather_clamp, gather_fill, wrap32
from repro_torch.core.arena import ChunkMeta
from repro_torch.core.heap import HeapConfig, size_to_class_device


class AllocState(NamedTuple):
    q: Any                 # queue-family state (views)
    ctx: queues.AllocCtx   # heap words + free-chunk pool (views)
    meta: ChunkMeta        # bitmaps / free counts / bindings (views)


def init(cfg: HeapConfig, family_name: str, state: AllocState) -> AllocState:
    """Fill the pool with every chunk, then give each class queue its
    first segment (in place on blank arena views)."""
    queues.pool_init(cfg, state.ctx.pool)
    queues.virt_init(cfg, state.q, state.ctx, family_name)
    return state


def _select_free_pages(row, ppc: int, take: int):
    """Indices (ascending) of the first ``take`` free pages below
    ``ppc`` in one chunk's bitmap row."""
    dev = row.device
    bits = (row.to(torch.int64)[:, None]
            >> torch.arange(32, device=dev)[None, :]) & 1
    occupied = bits.reshape(-1).bool()
    idx = torch.arange(occupied.shape[0], device=dev)
    free = (~occupied) & (idx < ppc)
    order = torch.cumsum(free.to(torch.int64), 0) - free.to(torch.int64)
    chosen = free & (order < take)
    return torch.nonzero(chosen)[:, 0].to(torch.int32)


def _set_bits(meta: ChunkMeta, chunk, page_idx, sign: int):
    """Set (+1) or clear (−1) page bits by wrapping add, and move the
    free counts by −sign per lane (the reference's scatter-add: bits
    are unique and in the opposite state, so add == OR / AND-NOT).
    Lanes outside the bitmap are dropped; the free-count update drops
    only on the chunk index."""
    nc, bw = meta.bitmap.shape
    chunk = chunk.to(torch.int64)
    page_idx = page_idx.to(torch.int64)
    word = page_idx // 32
    bitval = torch.ones_like(page_idx) << (page_idx % 32)
    ok_c = (chunk >= 0) & (chunk < nc)
    ok_b = ok_c & (word < bw)
    flat = meta.bitmap.view(-1)
    acc = flat.to(torch.int64)
    acc.index_add_(0, (chunk * bw + word)[ok_b], sign * bitval[ok_b])
    flat.copy_(wrap32(acc))
    meta.free_count.index_add_(
        0, chunk[ok_c],
        torch.full_like(chunk[ok_c], -sign, dtype=torch.int32))
    return meta


def alloc(cfg: HeapConfig, family_name: str, state: AllocState, sizes_bytes,
          mask):
    """One bulk alloc.  Returns (state, word offsets); −1 marks a
    masked, over-large or unserved lane."""
    fam = queues.family(family_name)
    C = cfg.num_classes
    n = sizes_bytes.shape[0]
    dev = sizes_bytes.device
    cls = size_to_class_device(cfg, sizes_bytes)
    valid = mask & (cls < C)
    counts = groups.segment_counts(cls, valid, C).tolist()
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    q, ctx, meta = state
    one = torch.ones(1, dtype=torch.bool, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    wpc = cfg.words_per_chunk

    for c in range(C):  # class-major; dynamic chunk drain inside
        if counts[c] == 0:
            continue
        ppc, pw = cfg.pages_per_chunk(c), cfg.page_words(c)
        ccls = torch.full((1,), c, dtype=torch.int32, device=dev)
        req_pos = torch.nonzero(valid & (cls == c))[:, 0]
        served, fail = 0, False
        while served < counts[c] and not fail:
            if int(fam.count(q)[c]) > 0:
                q, ctx, ch = fam.bulk_dequeue(cfg, q, ctx, ccls, zero, one)
                chunk, fail_now = int(ch[0]), False
            else:
                has = int(queues.pool_count(ctx.pool)) > 0
                _, ch = queues.pool_dequeue(cfg, ctx.pool, one & has)
                chunk, fail_now = int(ch[0]), not has
                if has and 0 <= chunk < cfg.num_chunks:
                    meta.bitmap[chunk] = 0
                    meta.free_count[chunk] = ppc
                    meta.chunk_class[chunk] = c
            if fail_now:
                fail = True
                continue
            # plain indexing of the chunk tables (clamps out of range)
            ct = torch.tensor([chunk], device=dev)
            f = int(gather_clamp(meta.free_count, ct)[0])
            t = min(counts[c] - served, f)
            row = gather_clamp(meta.bitmap, ct)[0]
            page_idx = _select_free_pages(row, ppc, t)
            k = page_idx.shape[0]
            chunk_t = torch.full((k,), chunk, dtype=torch.int32, device=dev)
            _set_bits(meta, chunk_t, page_idx, +1)
            out[req_pos[served:served + k]] = chunk * wpc + page_idx * pw
            # chunk still has pages → back into the class queue
            fc = gather_clamp(meta.free_count, ct)
            fam.bulk_enqueue(cfg, q, ctx, ccls, zero,
                             torch.full((1,), chunk, dtype=torch.int32,
                                        device=dev), fc > 0)
            served += t
    return AllocState(q, ctx, meta), out


def free(cfg: HeapConfig, family_name: str, state: AllocState, offsets_words,
         sizes_bytes, mask):
    """One bulk free; masked, over-large or negative-offset lanes are
    no-ops.  Revived chunks re-enter their class queues in ascending
    chunk-id order, ranked per class."""
    fam = queues.family(family_name)
    C = cfg.num_classes
    n = offsets_words.shape[0]
    nc = cfg.num_chunks
    dev = offsets_words.device
    cls = size_to_class_device(cfg, sizes_bytes)
    offs = offsets_words.to(torch.int32)
    valid = mask & (cls < C) & (offs >= 0)
    q, ctx, meta = state

    chunk = offs // cfg.words_per_chunk
    cm = (cls % C).to(torch.int64)
    pw = torch.full_like(cm, cfg.page_words(0)) << cm
    page_idx = (offs % cfg.words_per_chunk) // pw
    old_free = meta.free_count.clone()
    _set_bits(meta, chunk[valid], page_idx[valid], -1)

    touched = torch.zeros(nc, dtype=torch.bool, device=dev)
    hit = chunk[valid].to(torch.int64)
    touched[hit[hit < nc]] = True
    revived = touched & (old_free == 0)
    ids = torch.nonzero(revived)[:, 0].to(torch.int32)
    rev_ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rev_ids[:ids.shape[0]] = ids
    rev_ok = rev_ids >= 0
    rev_cls = gather_fill(meta.chunk_class, rev_ids, 0)
    rank, _ = groups.masked_rank(rev_cls, rev_ok, C)
    fam.bulk_enqueue(cfg, q, ctx, rev_cls, rank, rev_ids, rev_ok)
    return AllocState(q, ctx, meta)
