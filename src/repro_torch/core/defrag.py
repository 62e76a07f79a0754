"""Live defragmentation: a plan/execute migration wave (port of the
reference's ``core/defrag.py``).

``plan_math``  the **relocation plan** from arena state, in plain
    tensor ops on the arena's device: per size class, rank the bound
    chunks densest-first, keep the minimal prefix that holds every live
    page (the receivers) and move every live page of the other bound
    chunks (the donors) into the receivers' free slots.  The result is
    a fixed-width forwarding table ``(src, dst, sizes)`` of old→new word
    offsets, −1 padded.

``migrate_math``  the plain version of the **execute** step, the CUDA
    kernel ``csrc/defrag_txn.cu``: copy each extent's heap words, flip
    its bitmap bits, move the free counts, claim unbound destination
    chunks, unbind fully-free chunks, rebuild the pool from scratch and
    rebuild every class queue class-major.  It updates ``mem``/``ctl``
    in place; the telemetry words of ``ctl`` pass through unchanged.
    It is split into ``extract_math`` and ``insert_rebuild_math`` so
    that a sharded schedule can run them per shard.

``sharded_plan_math`` / ``sharded_migrate_math``  the same over a
    sharded arena: per-shard plans concatenated into one table of
    GLOBAL offsets, and a wave that extracts over every shard, then
    inserts and rebuilds every shard (the plain version of
    ``sharded_defrag_txn``).  Cross-shard moves come from
    ``shards.rebalance_plan_math`` and ride the same wave.

The planners guarantee that source extents and destination slots are
disjoint, so extract-then-insert equals a simultaneous move.  Page
kinds bind no chunks: their plans are empty and their waves no-ops.

Also here: fragmentation observability (``frag_stats_math``,
``_pool_members``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import arena, groups, queues
from repro_torch.core._index import gather_fill, scatter_drop_, wrap32
from repro_torch.core.chunk_alloc import _set_bits
from repro_torch.core.heap import HeapConfig, size_to_class_device

# Default forwarding-table width (the bound is static: it shapes the
# kernel's lane loop and the plan's buffers).
DEFAULT_MAX_MOVES = 128


class Forwarding(NamedTuple):
    """One wave's old→new relocation table (−1-padded lanes are no-ops):
    heap word offsets ``src``/``dst`` and extent sizes in bytes, the
    ``(offsets, sizes)`` vocabulary of ``alloc``/``free``."""
    src: Any    # (M,) int32
    dst: Any    # (M,) int32
    sizes: Any  # (M,) int32


def empty_forwarding(max_moves: int = 0, device="cpu") -> Forwarding:
    return Forwarding(
        src=torch.full((max_moves,), -1, dtype=torch.int32, device=device),
        dst=torch.full((max_moves,), -1, dtype=torch.int32, device=device),
        sizes=torch.zeros(max_moves, dtype=torch.int32, device=device))


def forward_offsets(fwd: Forwarding, offsets_words):
    """Remap word offsets through the forwarding table (offsets not in
    the table pass through unchanged, −1 lanes included)."""
    src = torch.where(fwd.src >= 0, fwd.src, torch.full_like(fwd.src, -2))
    hit = offsets_words[:, None] == src[None, :]
    new = torch.where(hit, fwd.dst[None, :],
                      torch.zeros_like(fwd.dst[None, :])).sum(1)
    return torch.where(hit.any(1), new.to(offsets_words.dtype),
                       offsets_words)


def _occupancy_bits(bitmap):
    """(nc, bw) int32 words → (nc, bw·32) bool, bit order LSB-first."""
    nc, bw = bitmap.shape
    sh = torch.arange(32, device=bitmap.device)
    bits = (bitmap.to(torch.int64)[:, :, None] >> sh[None, None, :]) & 1
    return bits.reshape(nc, bw * 32).bool()


# --------------------------------------------------------------------------
# plan: pick live extents in the sparsest chunks, assign dense targets
# --------------------------------------------------------------------------

def _take_bits(bits, order, limit, off_of_bit, max_moves: int):
    """The first ``limit`` set bits of ``bits``, visiting chunks in
    ``order`` and pages ascending within each chunk: their word offsets
    at positions [0, count) of a (max_moves,) int32 tensor (−1 padded),
    and the count.  Unused lanes scatter into one spare slot, so the
    plan needs no host read."""
    b = bits[order].reshape(-1)
    o = off_of_bit[order].reshape(-1).to(torch.int32)
    bi = b.to(torch.int64)
    ordinal = torch.cumsum(bi, 0) - bi
    take = b & (ordinal < limit)
    out = torch.full((max_moves + 1,), -1, dtype=torch.int32,
                     device=bits.device)
    out.scatter_(0, torch.where(take, ordinal, max_moves), o)
    return out[:max_moves], torch.minimum(bi.sum(), limit)


def plan_math(cfg: HeapConfig, kind: str, family: str, mem, ctl, *,
              max_moves: int = DEFAULT_MAX_MOVES):
    """Relocation plan for one arena: ``(src, dst, sizes)`` word
    offsets, −1 padded to ``max_moves``; reads the arena, writes
    nothing.

    Per class: chunks ranked densest-first (live pages descending, id
    ascending); the minimal receiver prefix that can hold all live
    pages keeps them, every other bound chunk donates.  Destinations
    are slots free before the wave and never slots another move
    vacates, so any prefix of the table is a valid smaller wave."""
    dev = mem.device
    if kind != "chunk":
        f = empty_forwarding(max_moves, dev)
        return f.src, f.dst, f.sizes
    lay = arena.layout(cfg, kind, family)
    _, _, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    nc = cfg.num_chunks
    wpc = cfg.words_per_chunk
    maxbits = cfg.bitmap_words_per_chunk * 32
    ids = torch.arange(nc, dtype=torch.int64, device=dev)
    bitpos = torch.arange(maxbits, dtype=torch.int64, device=dev)
    occ = _occupancy_bits(meta.bitmap)
    free = meta.free_count.to(torch.int64)

    def table(fill):
        return torch.full((max_moves + 1,), fill, dtype=torch.int32,
                          device=dev)

    src, dst, sz = table(-1), table(-1), table(0)
    k = torch.arange(max_moves, dtype=torch.int64, device=dev)
    base = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(cfg.num_classes):
        ppc = cfg.pages_per_chunk(c)
        pw = cfg.page_words(c)
        bound = meta.chunk_class == c
        in_range = bitpos[None, :] < ppc
        live = torch.where(bound, ppc - free, torch.zeros_like(free))
        need = (live.sum() + ppc - 1) // ppc
        # densest bound chunks first, unbound chunks last
        key = torch.where(bound, (ppc - live) * nc + ids,
                          (ppc + 1) * nc + ids)
        order = torch.argsort(key, stable=True)
        rank = torch.empty_like(ids).scatter_(0, order, ids)
        is_recv = bound & (rank < need)
        is_donor = bound & (rank >= need)
        src_bits = occ & is_donor[:, None] & in_range
        dst_bits = (~occ) & is_recv[:, None] & in_range
        budget = torch.clamp(max_moves - base, min=0)
        budget = torch.minimum(budget, src_bits.sum())
        off_of = ids[:, None] * wpc + bitpos[None, :] * pw
        s_off, cnt = _take_bits(src_bits, order, budget, off_of, max_moves)
        d_off, _ = _take_bits(dst_bits, order, budget, off_of, max_moves)
        pos = torch.where(k < cnt, base + k, max_moves)
        src.scatter_(0, pos, s_off)
        dst.scatter_(0, pos, d_off)
        sz.scatter_(0, pos, torch.full_like(s_off, cfg.page_bytes(c)))
        base = base + cnt
    return src[:max_moves], dst[:max_moves], sz[:max_moves]


def sharded_plan_math(cfg: HeapConfig, num_shards: int, kind: str,
                      family: str, mem, ctl, *,
                      max_moves: int = DEFAULT_MAX_MOVES):
    """Per-shard plans (``plan_math`` on each shard) concatenated in
    shard order into one GLOBAL-offset table, truncated at
    ``max_moves``; reads the arena, writes nothing."""
    from repro_torch.core import shards  # defrag <-> shards
    dev = mem.device
    if kind != "chunk":
        f = empty_forwarding(max_moves, dev)
        return f.src, f.dst, f.sizes
    scfg = shards.shard_config(cfg, num_shards)
    Ws = scfg.total_words

    def table(fill):
        return torch.full((max_moves + 1,), fill, dtype=torch.int32,
                          device=dev)

    src, dst, sz = table(-1), table(-1), table(0)
    base = torch.zeros((), dtype=torch.int64, device=dev)
    k = torch.arange(max_moves, dtype=torch.int64, device=dev)
    for s in range(num_shards):
        s_src, s_dst, s_sz = plan_math(scfg, kind, family, mem[s], ctl[s],
                                       max_moves=max_moves)
        cnt = torch.minimum((s_src >= 0).sum(), max_moves - base)
        pos = torch.where(k < cnt, base + k, max_moves)
        src.scatter_(0, pos, s_src + s * Ws)
        dst.scatter_(0, pos, s_dst + s * Ws)
        sz.scatter_(0, pos, s_sz)
        base = base + cnt
    return src[:max_moves], dst[:max_moves], sz[:max_moves]


# --------------------------------------------------------------------------
# execute: extract / insert+rebuild (the plain version of defrag_txn)
# --------------------------------------------------------------------------

def _move_lanes(cfg: HeapConfig, offsets, sizes, sel):
    """Lanes that move (selected, offset ≥ 0, a valid class) and each
    lane's page words."""
    C = cfg.num_classes
    cls = size_to_class_device(cfg, sizes).to(torch.int64)
    valid = sel & (offsets >= 0) & (cls < C)
    pw = torch.full_like(cls, cfg.page_words(0)) << (cls % C)
    return valid, pw


def _extent_words(cfg: HeapConfig, offsets, valid, pw):
    """(M, words_per_chunk) heap word indices of each lane's extent;
    words outside it (and invalid lanes) index ``total_words``, where a
    gather reads the fill and a scatter drops."""
    j = torch.arange(cfg.words_per_chunk, device=offsets.device)[None, :]
    ok = valid[:, None] & (j < pw[:, None])
    return ok, torch.where(ok, offsets.to(torch.int64)[:, None] + j,
                           cfg.total_words)


def _chunk_page(cfg: HeapConfig, offsets, valid, pw):
    wpc = cfg.words_per_chunk
    off = offsets.to(torch.int64)
    chunk = torch.where(valid, off // wpc, cfg.num_chunks)
    page = torch.where(valid, (off % wpc) // pw, 0)
    return chunk, page


def extract_math(cfg: HeapConfig, kind: str, family: str, mem, ctl, src,
                 sizes, sel, buf):
    """Phase 0 of a wave on one arena: copy the selected extents' heap
    words into their rows of ``buf`` (M, words_per_chunk), clear their
    bitmap bits and return their pages to the free counts.  Queues and
    ``ctl`` are untouched.  Updates ``mem`` and ``buf`` in place and
    returns them."""
    lay = arena.layout(cfg, kind, family)
    _, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    valid, pw = _move_lanes(cfg, src, sizes, sel)
    ok, words = _extent_words(cfg, src, valid, pw)
    vals = gather_fill(ctx.heap, words.reshape(-1), 0).reshape(words.shape)
    buf.copy_(torch.where(ok, vals, buf))
    chunk, page = _chunk_page(cfg, src, valid, pw)
    _set_bits(meta, chunk[valid], page[valid], -1)
    return mem, buf


def insert_rebuild_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
                        dst, sizes, sel, buf):
    """Phase 1 of a wave on one arena: write the buffered extents at
    their destinations, claim destination chunks that are still unbound
    (bitmap reset, full free count, bound to the move's class, as
    alloc's from-pool path), set the destination bits, then the
    class-major rebuild: unbind fully-free chunks, re-prime a fresh
    pool with every unbound id in ascending order, empty the class
    queues and enqueue each class's live chunks in ascending order (a
    ring at slots 0..k-1; a virtualized queue after one fresh segment
    from the pool, which vl terminates and va enters at directory slot
    0).  Runs even for an empty selection.  Updates ``mem``/``ctl``
    in place (telemetry words pass through) and returns them."""
    lay = arena.layout(cfg, kind, family)
    q, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    C = cfg.num_classes
    nc = cfg.num_chunks
    W = cfg.total_words
    wpc = cfg.words_per_chunk
    dev = mem.device
    valid, pw = _move_lanes(cfg, dst, sizes, sel)

    # insert the buffered words
    ok, words = _extent_words(cfg, dst, valid, pw)
    scatter_drop_(ctx.heap, words.reshape(-1), buf.reshape(-1))
    chunk, page = _chunk_page(cfg, dst, valid, pw)

    # claim destination chunks that are still unbound
    cls = size_to_class_device(cfg, sizes).to(torch.int64)
    hit = torch.zeros(nc + 1, dtype=torch.bool, device=dev)
    hit[torch.clamp(chunk, max=nc)] = True
    claimed = hit[:nc] & (meta.chunk_class < 0)
    meta.bitmap.masked_fill_(claimed[:, None], 0)
    lane = valid & (chunk < nc) & claimed[chunk % nc]
    ppc_move = cfg.max_pages_per_chunk >> torch.clamp(cls, 0, C - 1)
    meta.free_count[chunk[lane]] = ppc_move[lane].to(torch.int32)
    meta.chunk_class[chunk[lane]] = cls[lane].to(torch.int32)
    _set_bits(meta, chunk[valid], page[valid], +1)

    # unbind fully-free chunks; a fresh pool holds every unbound id
    cc = meta.chunk_class
    full = cfg.max_pages_per_chunk >> torch.clamp(cc, 0, C - 1)
    cc.masked_fill_((cc >= 0) & (meta.free_count == full), -1)
    ids = torch.arange(nc, dtype=torch.int32, device=dev)
    queues.ring_init(ctx.pool)
    queues.pool_enqueue(cfg, ctx.pool, ids, cc < 0)

    # class-major queue rebuild: empty queues, then per class (a
    # virtualized queue first pops one fresh segment: vl terminates it,
    # va enters it at directory slot 0) one bulk enqueue of the class's
    # live chunks in ascending order; every pool pop happens in class
    # order
    fam = queues.family(family)
    if family == "ring":
        queues.ring_init(q)
    else:
        queues.virt_reset(q)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    ones = torch.ones(nc, dtype=torch.int32, device=dev)
    for c in range(C):
        live_c = (cc == c) & (meta.free_count > 0)
        if family != "ring":
            _, seg0 = queues.pool_dequeue(cfg, ctx.pool, one)
            if family == "vl":
                w0 = seg0.to(torch.int64) * wpc
                scatter_drop_(ctx.heap,
                              torch.where((w0 >= 0) & (w0 < W), w0, W),
                              queues.NULL)
            else:
                q.directory[c, 0] = seg0[0]
            q.head[c:c + 1] = seg0
            q.tail[c:c + 1] = seg0
        rk = groups.masked_prefix_sum(ones, live_c)
        fam.bulk_enqueue(cfg, q, ctx, torch.full_like(ids, c), rk, ids,
                         live_c)
    return mem, ctl


def migrate_math(cfg: HeapConfig, kind: str, family: str, mem, ctl, src,
                 dst, sizes):
    """One whole migration wave on one arena (extract → insert →
    class-major rebuild), in place on ``mem``/``ctl``: the plain version
    of ``csrc/defrag_txn.cu``.  Returns ``(mem, ctl)``."""
    if kind != "chunk":
        return mem, ctl
    buf = torch.zeros((src.shape[0], cfg.words_per_chunk),
                      dtype=torch.int32, device=mem.device)
    valid = (src >= 0) & (dst >= 0)
    extract_math(cfg, kind, family, mem, ctl, src, sizes, valid, buf)
    return insert_rebuild_math(cfg, kind, family, mem, ctl, dst, sizes,
                               valid, buf)


def sharded_migrate_math(cfg: HeapConfig, num_shards: int, kind: str,
                         family: str, mem, ctl, src, dst, sizes):
    """One sharded wave, in place on ``mem``/``ctl`` (S, ·): extract
    over every shard, then insert and rebuild over every shard (a shard
    with no moves is rebuilt too, so a donor retires its emptied chunks
    in the same wave).  Cross-shard moves ride the carry buffer between
    the phases.  The plain version of ``csrc/defrag_txn.cu``'s
    ``sharded_defrag_txn``.  Returns ``(mem, ctl)``."""
    from repro_torch.core import shards  # defrag <-> shards
    if kind != "chunk":
        return mem, ctl
    scfg = shards.shard_config(cfg, num_shards)
    Ws = scfg.total_words
    buf = torch.zeros((src.shape[0], scfg.words_per_chunk),
                      dtype=torch.int32, device=mem.device)
    valid = (src >= 0) & (dst >= 0)
    neg = torch.full_like(src, -1)
    src_sh = torch.where(src >= 0, torch.div(src, Ws, rounding_mode="floor"),
                         neg)
    dst_sh = torch.where(dst >= 0, torch.div(dst, Ws, rounding_mode="floor"),
                         neg)
    for s in range(num_shards):
        sel = valid & (src_sh == s)
        extract_math(scfg, kind, family, mem[s], ctl[s],
                     torch.where(sel, src - s * Ws, neg), sizes, sel, buf)
    for s in range(num_shards):
        sel = valid & (dst_sh == s)
        insert_rebuild_math(scfg, kind, family, mem[s], ctl[s],
                            torch.where(sel, dst - s * Ws, neg), sizes, sel,
                            buf)
    return mem, ctl


# --------------------------------------------------------------------------
# fragmentation observability
# --------------------------------------------------------------------------

def _pool_members(cfg: HeapConfig, pool):
    """Bool mask over chunk ids: currently queued in the free pool."""
    nc = cfg.num_chunks
    dev = pool.store.device
    cnt = (pool.back - pool.front)[0]
    k = torch.arange(nc, dtype=torch.int64, device=dev)
    slots = (pool.front[0].to(torch.int64) + k) % nc
    ids = pool.store[0, slots].to(torch.int64)
    live = (k < cnt) & (ids >= 0) & (ids < nc)
    out = torch.zeros(nc, dtype=torch.bool, device=dev)
    out[ids[live]] = True
    return out


def frag_stats_math(cfg: HeapConfig, kind: str, family: str, mem, ctl):
    """``(free_words, largest_free_extent)`` of one arena.  Chunk kinds:
    a word is free iff its chunk sits in the pool or it belongs to a
    free page of a bound chunk; the largest extent is the longest run.
    Page kinds carve their inventory at init: the free words are the
    queued pages of each class times its page words, the largest extent
    the largest page class still queued."""
    lay = arena.layout(cfg, kind, family)
    C = cfg.num_classes
    if kind != "chunk":
        front = ctl[lay.off_front:lay.off_front + C]
        back = ctl[lay.off_back:lay.off_back + C]
        counts = back - front
        pws = torch.tensor([cfg.page_words(c) for c in range(C)],
                           dtype=torch.int32, device=ctl.device)
        return (wrap32((counts.to(torch.int64) * pws).sum()),
                torch.where(counts > 0, pws, torch.zeros_like(pws)).max())
    _, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    dev = mem.device
    wpc = cfg.words_per_chunk
    maxbits = cfg.bitmap_words_per_chunk * 32
    occ = _occupancy_bits(meta.bitmap)
    bound = meta.chunk_class >= 0
    cc = torch.clamp(meta.chunk_class, 0, C - 1).to(torch.int64)
    pw = torch.full_like(cc, cfg.page_words(0)) << cc
    ppc = torch.full_like(cc, cfg.max_pages_per_chunk) >> cc
    bit_ix = torch.arange(maxbits, device=dev)
    free_page = (~occ) & bound[:, None] & (bit_ix[None, :] < ppc[:, None])
    word_page = torch.clamp(
        torch.arange(wpc, device=dev)[None, :] // pw[:, None],
        max=maxbits - 1)
    in_pool = _pool_members(cfg, ctx.pool)
    free_mask = (in_pool[:, None]
                 | (bound[:, None]
                    & torch.gather(free_page, 1, word_page))).reshape(-1)
    idx = torch.arange(free_mask.shape[0], dtype=torch.int64, device=dev)
    blocked = torch.where(~free_mask, idx, torch.full_like(idx, -1))
    last_blocked = torch.cummax(blocked, 0).values
    run = torch.where(free_mask, idx - last_blocked, torch.zeros_like(idx))
    return free_mask.sum(), run.max()


def frag_ratio(free_words, largest_free_extent):
    """``1 − largest_free/total_free``: 0 = one solid free block."""
    fw = int(free_words)
    if fw <= 0:
        return 0.0
    # float32, as the reference computes it
    r = np.float32(1.0) - np.float32(int(largest_free_extent)) \
        / np.float32(max(fw, 1))
    return float(r)
