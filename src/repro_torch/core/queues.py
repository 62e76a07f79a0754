"""Ouroboros queues as in-place tensor state machines (port).

The state tuples hold *views* into the flat arena (``core/arena.py``):
every bulk function updates ``mem``/``ctl`` in place and returns the
same views, so a transaction never copies the arena.  Each function
reads the counters it needs before writing any of them, which keeps the
reference's functional semantics.

Ported so far: the free-chunk pool ring (``pool_*``, ``ring_bulk_*``
as the pool uses them), ``virt_init``, and the virtualized **list**
family (``vl_bulk_enqueue``/``vl_bulk_dequeue``), whose segments are
heap chunks chained through a next pointer in word 0.  The ``va``
family and the plain class rings are ROADMAP items A3/A16.

GPU Ouroboros moves front/back with per-thread atomics; here a batch
is one transaction: every lane carries a class and an intra-class rank
(``groups.masked_rank``), counters advance once per class, and slot
addresses are ``counter + rank``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import groups
from repro_torch.core._index import gather2_fill, gather_fill, scatter_drop_
from repro_torch.core.heap import HeapConfig

NULL = -1


class RingState(NamedTuple):
    store: Any  # (C, cap) int32
    front: Any  # (C,) int32, monotonically increasing virtual index
    back: Any   # (C,) int32


class AllocCtx(NamedTuple):
    heap: Any        # (total_words,) int32
    pool: RingState  # single-class ring of free chunk ids


class VirtState(NamedTuple):
    directory: Any  # (C, max_segs) int32 (va only; vl keeps it NULL)
    head: Any       # (C,) int32 chunk ids
    tail: Any       # (C,) int32 chunk ids
    front: Any      # (C,) int32
    back: Any       # (C,) int32


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


# --------------------------------------------------------------------------
# plain ring family (as the pool uses it)
# --------------------------------------------------------------------------

def ring_bulk_dequeue(cfg: HeapConfig, q: RingState, ctx, cls, rank, mask):
    cap = q.store.shape[1]
    C = q.store.shape[0]
    counts = groups.segment_counts(cls, mask, C)
    cm = (cls % C).to(torch.int64)
    pos = ((q.front[cm] + rank) % cap).to(torch.int64)
    vals = q.store[cm, pos]
    vals = torch.where(mask, vals, torch.full_like(vals, NULL))
    q.front.add_(counts)
    return q, ctx, vals


def ring_bulk_enqueue(cfg: HeapConfig, q: RingState, ctx, cls, rank, vals,
                      mask):
    cap = q.store.shape[1]
    C = q.store.shape[0]
    counts = groups.segment_counts(cls, mask, C)
    cm = (cls % C).to(torch.int64)
    pos = ((q.back[cm] + rank) % cap).to(torch.int64)
    q.store[cm[mask], pos[mask]] = vals.to(torch.int32)[mask]
    q.back.add_(counts)
    return q, ctx


# --------------------------------------------------------------------------
# chunk pool (single-class ring of free chunk ids)
# --------------------------------------------------------------------------

def pool_init(cfg: HeapConfig, pool: RingState) -> RingState:
    """All heap chunks start free, queued FIFO in the pool (in place)."""
    pool.store[0] = torch.arange(cfg.num_chunks, dtype=torch.int32,
                                 device=pool.store.device)
    pool.front.zero_()
    pool.back.fill_(cfg.num_chunks)
    return pool


def pool_count(pool: RingState):
    return (pool.back - pool.front)[0]


def pool_dequeue(cfg: HeapConfig, pool: RingState, mask):
    """Pop one chunk id per active lane.  No inventory check: popping
    an empty pool reads whatever id the ring slot still holds, exactly
    as the reference does."""
    rank = groups.masked_prefix_sum(torch.ones_like(mask, dtype=torch.int32),
                                    mask)
    cls = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    pool, _, chunks = ring_bulk_dequeue(cfg, pool, None, cls, rank, mask)
    return pool, chunks


def pool_enqueue(cfg: HeapConfig, pool: RingState, chunks, mask):
    rank = groups.masked_prefix_sum(torch.ones_like(mask, dtype=torch.int32),
                                    mask)
    cls = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    pool, _ = ring_bulk_enqueue(cfg, pool, None, cls, rank, chunks, mask)
    return pool


# --------------------------------------------------------------------------
# virtualized queues
# --------------------------------------------------------------------------

def _grow_counts(counts, back, spc):
    """Segments to append so slots [back, back+counts) plus the next
    insertion point all live in allocated segments."""
    return (back + counts) // spc - back // spc


def _shrink_counts(counts, front, spc):
    """Segments fully consumed once front advances by ``counts``."""
    return (front + counts) // spc - front // spc


def _grid_mask(n_per_class, m):
    """(C, m) mask: entry [c, j] active iff j < n_per_class[c]."""
    return _arange(m, n_per_class.device)[None, :] < n_per_class[:, None]


def virt_init(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, family: str):
    """Give every class one empty segment popped from the pool (in
    place on the arena views)."""
    if family != "vl":
        raise NotImplementedError(
            f"{family!r} queues are not ported yet (ROADMAP A3)")
    C = q.front.shape[0]
    mask = torch.ones(C, dtype=torch.bool, device=q.front.device)
    _, seg0 = pool_dequeue(cfg, ctx.pool, mask)
    scatter_drop_(ctx.heap, seg0 * cfg.words_per_chunk, NULL)
    q.head.copy_(seg0)
    q.tail.copy_(seg0)
    q.front.zero_()
    q.back.zero_()
    return q, ctx


def virt_count(q: VirtState):
    return q.back - q.front


def vl_bulk_enqueue(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, cls, rank,
                    vals, mask):
    """Append ``vals`` (active lanes) to their class queues.  Grows
    each class's chain with chunks popped from the pool, flattened
    class-major over a (C, m) grid, m = n // spc + 1."""
    spc = cfg.slots_per_segment("vl")
    wpc = cfg.words_per_chunk
    C = q.front.shape[0]
    n = cls.shape[0]
    m = n // spc + 1
    dev = cls.device
    counts = groups.segment_counts(cls, mask, C)
    heap = ctx.heap
    W = heap.shape[0]
    back0, tail0 = q.back.clone(), q.tail.clone()

    # 1. grow: pop new segment chunks and chain them after the tail.
    n_new = _grow_counts(counts, back0, spc)
    grid = _grid_mask(n_new, m)
    _, new_chunks = pool_dequeue(cfg, ctx.pool, grid.reshape(-1))
    new_chunks = new_chunks.reshape(C, m)
    Wt = _i32(W, dev)
    scatter_drop_(heap, torch.where(grid, new_chunks * wpc, Wt), NULL)
    for j in range(m):
        prev = tail0 if j == 0 else new_chunks[:, j - 1]
        scatter_drop_(heap, torch.where(grid[:, j], prev * wpc, Wt),
                      new_chunks[:, j])

    # 2. write values: relative segment 0 is the tail chunk, segment
    # j > 0 is new_chunks[:, j-1].
    cm = (cls % C).to(torch.int64)
    v = back0[cm] + rank
    seg_rel = v // spc - back0[cm] // spc
    seg_chunk = torch.where(seg_rel == 0, tail0[cm],
                            gather2_fill(new_chunks, cm, seg_rel - 1, 0))
    word = seg_chunk * wpc + 1 + v % spc
    scatter_drop_(heap, torch.where(mask, word, Wt), vals)

    last = torch.clamp(n_new - 1, min=0).to(torch.int64)
    tail = torch.where(n_new > 0,
                       new_chunks[torch.arange(C, device=dev), last], tail0)
    q.tail.copy_(tail)
    q.back.add_(counts)
    return q, ctx


def vl_bulk_dequeue(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, cls, rank,
                    mask):
    """Pop one value per active lane.  Walks the chain m + 1 hops from
    the head; fully consumed leading segments go back to the pool."""
    spc = cfg.slots_per_segment("vl")
    wpc = cfg.words_per_chunk
    C = q.front.shape[0]
    n = cls.shape[0]
    m = n // spc + 1
    dev = cls.device
    counts = groups.segment_counts(cls, mask, C)
    heap = ctx.heap
    head0, front0 = q.head.clone(), q.front.clone()

    # 1. walk the chain from the head segment.
    chain = [head0]
    for _ in range(m):
        nxt = gather_fill(heap, chain[-1] * wpc, -1)
        chain.append(torch.where(chain[-1] >= 0, nxt,
                                 torch.full_like(nxt, NULL)))
    chain = torch.stack(chain, 1)  # (C, m+1)

    # 2. gather values.
    cm = (cls % C).to(torch.int64)
    v = front0[cm] + rank
    seg_rel = v // spc - front0[cm] // spc
    seg_chunk = gather2_fill(chain, cm, seg_rel, 0)
    word = seg_chunk * wpc + 1 + v % spc
    vals = gather_fill(heap, word, -1)
    vals = torch.where(mask, vals, torch.full_like(vals, NULL))

    # 3. shrink: fully consumed leading segments return to the pool.
    n_free = _shrink_counts(counts, front0, spc)
    grid = _grid_mask(n_free, m)
    pool_enqueue(cfg, ctx.pool, chain[:, :m].reshape(-1), grid.reshape(-1))
    head = chain[torch.arange(C, device=dev), n_free.to(torch.int64)]
    q.head.copy_(head)
    q.front.add_(counts)
    return q, ctx, vals


class QueueFamily(NamedTuple):
    name: str
    count: Any
    bulk_dequeue: Any
    bulk_enqueue: Any


FAMILIES = {
    "vl": QueueFamily("vl", virt_count, vl_bulk_dequeue, vl_bulk_enqueue),
}


def family(name: str) -> QueueFamily:
    if name not in FAMILIES:
        raise NotImplementedError(
            f"queue family {name!r} is not ported yet (ROADMAP A3)")
    return FAMILIES[name]
