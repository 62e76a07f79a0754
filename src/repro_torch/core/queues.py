"""Ouroboros queues as in-place tensor state machines (port).

The state tuples hold *views* into the flat arena (``core/arena.py``):
every bulk function updates ``mem``/``ctl`` in place and returns the
same views, so a transaction never copies the arena.  Each function
reads the counters it needs before writing any of them, which keeps the
reference's functional semantics.

The three families of the reference, as its paper benchmarks them:

- ``ring``  a plain pre-allocated ring per class (also the free-chunk
            pool, ``pool_*``);
- ``va``    the virtualized *array* queue: a ring **directory** of
            segment chunk ids per class; virtual slot ``v`` lives in
            heap chunk ``dir[v // spc]``;
- ``vl``    the virtualized *list* queue: segments are heap chunks
            chained through a next pointer in word 0.

GPU Ouroboros moves front/back with per-thread atomics; here a batch
is one transaction: every lane carries a class and an intra-class rank
(``groups.masked_rank``), counters advance once per class, and slot
addresses are ``counter + rank``.

Every bulk function takes a keyword ``piecewise`` (default False, the
port's spelling of the reference's ``backend="pallas"``).  With it, the
ring pops and pushes (class rings and the pool) go through
``kernels/ops.ring_txn_pop``/``ring_txn_push``, which recompute each
lane's rank in the kernel (every caller's ``rank`` is
``groups.masked_rank`` of the same lanes), and the ``va`` shrink reads
its directory window through ``ops.ring_window``: the CUDA kernels for
tensors on the card, their plain versions on the CPU.  Without it the
functions are plain tensor code, which is what the transaction math,
the defragmentation wave and the serving engine run.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import groups
from repro_torch.core._index import gather2_fill, gather_fill, scatter_drop_
from repro_torch.core.heap import HeapConfig
from repro_torch.kernels import ops

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


def _lanes(t):
    """An int32 contiguous lane vector, as the kernels take it."""
    return t.to(torch.int32).contiguous()


# --------------------------------------------------------------------------
# plain ring family
# --------------------------------------------------------------------------

def ring_init(q: RingState) -> RingState:
    """Empty rings (the reference's ``ring_init``), in place: NULL
    store, zero front and back."""
    q.store.fill_(NULL)
    q.front.zero_()
    q.back.zero_()
    return q


def ring_count(q: RingState):
    return q.back - q.front


def ring_bulk_dequeue(cfg: HeapConfig, q: RingState, ctx, cls, rank, mask,
                      *, piecewise: bool = False):
    """Pop one value per active lane: slot ``front + rank`` of its
    class's ring, with no inventory check (the pool's semantics)."""
    if piecewise:
        vals, new_front = ops.ring_txn_pop(q.store, q.front, q.back,
                                           _lanes(cls), mask, limit=False)
        q.front.copy_(new_front)
        return q, ctx, vals
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
                      mask, *, piecewise: bool = False):
    """Write each active lane's value at slot ``back + rank`` of its
    class's ring."""
    if piecewise:
        _, new_back = ops.ring_txn_push(q.store, q.back, _lanes(cls),
                                        _lanes(vals), mask)
        q.back.copy_(new_back)
        return q, ctx
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


def _pool_lanes(mask, piecewise: bool):
    """Class 0 for every lane, and (plain route only) the lanes'
    prefix ranks; the kernels rank in place."""
    cls = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    if piecewise:
        return cls, None
    return cls, groups.masked_prefix_sum(
        torch.ones_like(mask, dtype=torch.int32), mask)


def pool_dequeue(cfg: HeapConfig, pool: RingState, mask, *,
                 piecewise: bool = False):
    """Pop one chunk id per active lane.  No inventory check: popping
    an empty pool reads whatever id the ring slot still holds, exactly
    as the reference does."""
    cls, rank = _pool_lanes(mask, piecewise)
    pool, _, chunks = ring_bulk_dequeue(cfg, pool, None, cls, rank, mask,
                                        piecewise=piecewise)
    return pool, chunks


def pool_enqueue(cfg: HeapConfig, pool: RingState, chunks, mask, *,
                 piecewise: bool = False):
    cls, rank = _pool_lanes(mask, piecewise)
    pool, _ = ring_bulk_enqueue(cfg, pool, None, cls, rank, chunks, mask,
                                piecewise=piecewise)
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


def virt_init(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, family: str, *,
              piecewise: bool = False):
    """Give every class one empty segment popped from the pool (in
    place on the arena views): ``va`` enters it at directory slot 0,
    ``vl`` terminates its chain; both keep it as head and tail."""
    C = q.front.shape[0]
    mask = torch.ones(C, dtype=torch.bool, device=q.front.device)
    _, seg0 = pool_dequeue(cfg, ctx.pool, mask, piecewise=piecewise)
    q.directory.fill_(NULL)
    if family == "vl":
        scatter_drop_(ctx.heap, seg0 * cfg.words_per_chunk, NULL)
    else:
        q.directory[:, 0] = seg0
    q.head.copy_(seg0)
    q.tail.copy_(seg0)
    q.front.zero_()
    q.back.zero_()
    return q, ctx


def virt_reset(q: VirtState) -> VirtState:
    """Fresh virtualized queues with no segment yet, in place: NULL
    directory, head and tail; zero front and back."""
    q.directory.fill_(NULL)
    q.head.fill_(NULL)
    q.tail.fill_(NULL)
    q.front.zero_()
    q.back.zero_()
    return q


def virt_count(q: VirtState):
    return q.back - q.front


# --------------------------------------------------------------------------
# virtualized ARRAY queue (directory-indexed)
# --------------------------------------------------------------------------

def va_bulk_enqueue(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, cls, rank,
                    vals, mask, *, piecewise: bool = False):
    """Append ``vals`` (active lanes) to their class queues.  Grows
    each class's directory with chunks popped from the pool, flattened
    class-major over a (C, m) grid, m = n // spc + 1, then writes each
    value through the grown directory."""
    spc = cfg.slots_per_segment("va")
    wpc = cfg.words_per_chunk
    C, max_segs = q.directory.shape
    n = cls.shape[0]
    m = n // spc + 1
    dev = cls.device
    counts = groups.segment_counts(cls, mask, C)
    back0 = q.back.clone()

    # 1. grow: append segments so the whole write window is backed.
    n_new = _grow_counts(counts, back0, spc)
    grid = _grid_mask(n_new, m)
    _, new_chunks = pool_dequeue(cfg, ctx.pool, grid.reshape(-1),
                                 piecewise=piecewise)
    new_chunks = new_chunks.reshape(C, m)
    dir_pos = ((back0 // spc)[:, None] + 1 + _arange(m, dev)[None, :]) \
        % max_segs
    rows = torch.arange(C, device=dev)[:, None].expand(C, m)
    q.directory[rows[grid], dir_pos[grid].to(torch.int64)] = new_chunks[grid]

    # 2. write values through the grown directory.
    cm = (cls % C).to(torch.int64)
    v = back0[cm] + rank
    seg_chunk = gather2_fill(q.directory, cm, (v // spc) % max_segs, 0)
    word = seg_chunk * wpc + v % spc
    scatter_drop_(ctx.heap, torch.where(mask, word, _i32(ctx.heap.shape[0],
                                                         dev)), vals)
    q.back.add_(counts)
    return q, ctx


def va_bulk_dequeue(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, cls, rank,
                    mask, *, piecewise: bool = False):
    """Pop one value per active lane through the directory; segments
    fully consumed return to the pool.  The directory window of those
    segments is ``ops.ring_window`` on the piecewise route."""
    spc = cfg.slots_per_segment("va")
    wpc = cfg.words_per_chunk
    C, max_segs = q.directory.shape
    n = cls.shape[0]
    m = n // spc + 1
    dev = cls.device
    counts = groups.segment_counts(cls, mask, C)
    front0 = q.front.clone()

    # 1. gather values.
    cm = (cls % C).to(torch.int64)
    v = front0[cm] + rank
    seg_chunk = gather2_fill(q.directory, cm, (v // spc) % max_segs, 0)
    vals = gather_fill(ctx.heap, seg_chunk * wpc + v % spc, -1)
    vals = torch.where(mask, vals, torch.full_like(vals, NULL))

    # 2. shrink: return fully consumed segments to the pool.
    n_free = _shrink_counts(counts, front0, spc)
    grid = _grid_mask(n_free, m)
    seg_front = front0 // spc
    if piecewise:
        # a window of min(m, max_segs) columns; column j of the grid
        # reads column j mod that width, its same directory slot
        mw = min(m, max_segs)
        freed = ops.ring_window(q.directory, seg_front, n_free, m=mw)
        if mw < m:
            freed = freed[:, torch.arange(m, device=dev) % mw]
    else:
        dir_pos = (seg_front[:, None] + _arange(m, dev)[None, :]) % max_segs
        freed = q.directory[torch.arange(C, device=dev)[:, None],
                            dir_pos.to(torch.int64)]
    pool_enqueue(cfg, ctx.pool, freed.reshape(-1), grid.reshape(-1),
                 piecewise=piecewise)
    q.front.add_(counts)
    return q, ctx, vals


# --------------------------------------------------------------------------
# virtualized LIST queue (next-pointer chained)
# --------------------------------------------------------------------------

def vl_bulk_enqueue(cfg: HeapConfig, q: VirtState, ctx: AllocCtx, cls, rank,
                    vals, mask, *, piecewise: bool = False):
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
    _, new_chunks = pool_dequeue(cfg, ctx.pool, grid.reshape(-1),
                                 piecewise=piecewise)
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
                    mask, *, piecewise: bool = False):
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
    pool_enqueue(cfg, ctx.pool, chain[:, :m].reshape(-1), grid.reshape(-1),
                 piecewise=piecewise)
    # plain indexing: an index in [-(m+1), 0) wraps, any other out of
    # range clamps (n_free turns negative once front + counts wraps 2^31)
    col = n_free.to(torch.int64)
    col = torch.clamp(torch.where(col < 0, col + m + 1, col), 0, m)
    head = chain[torch.arange(C, device=dev), col]
    q.head.copy_(head)
    q.front.add_(counts)
    return q, ctx, vals


def init_queues(cfg: HeapConfig, family_name: str, q, ctx: AllocCtx, *,
                piecewise: bool = False):
    """Empty class queues of one family, in place: empty rings, or one
    empty segment per class popped from the pool."""
    family(family_name)
    if family_name == "ring":
        ring_init(q)
    else:
        virt_init(cfg, q, ctx, family_name, piecewise=piecewise)
    return q, ctx


class QueueFamily(NamedTuple):
    name: str
    count: Any
    bulk_dequeue: Any
    bulk_enqueue: Any


FAMILIES = {
    "ring": QueueFamily("ring", ring_count, ring_bulk_dequeue,
                        ring_bulk_enqueue),
    "va": QueueFamily("va", virt_count, va_bulk_dequeue, va_bulk_enqueue),
    "vl": QueueFamily("vl", virt_count, vl_bulk_dequeue, vl_bulk_enqueue),
}


def family(name: str) -> QueueFamily:
    if name not in FAMILIES:
        raise ValueError(f"unknown queue family {name!r}; pick from "
                         f"{tuple(FAMILIES)}")
    return FAMILIES[name]
