"""Allocator transactions over the device-resident arena (port).

Every variant is a ``(kind, family)`` pair and every transaction runs
against one :class:`arena.Arena`.  Two paths share one contract:

``alloc_math`` / ``free_math``  the plain PyTorch transaction: unpack
    the arena into views, run ``page_alloc`` or ``chunk_alloc`` and the
    telemetry update, all in place.  The CPU path and the parity tests
    run it.

``alloc`` / ``free``  the dispatcher: ``kernels/ops`` launches the CUDA
    transaction kernel for an arena on the card and runs the math for
    one on the CPU.  There is no backend or lowering knob: the arena's
    device decides.

``migrate``  the execute step of one defragmentation wave (whose plan
    ``defrag.plan_math`` computes in plain tensor ops on the arena's
    device), dispatched like a transaction: the CUDA kernel
    ``csrc/defrag_txn.cu`` on the card, ``defrag.migrate_math`` on the
    CPU.

``sharded_*``  the same contract over a
    :class:`~repro_torch.core.shards.ShardedArena` (S independent
    arenas, home-shard routing, bounded overflow walk).  The contract
    is a schedule: ``sharded_alloc_math``/``sharded_free_math`` replay
    it serially through the single-arena math, and the dispatchers
    launch ONE CUDA kernel per transaction or wave on the card
    (``sharded_alloc_txn``, ``sharded_free_txn``, ``sharded_defrag_txn``).

``compact`` / ``sharded_compact``  the host-triggered chunk rebind of
    chunk kinds (``chunk_alloc.compact``; a no-op for page kinds), plain
    tensor code on either device.

Both update ``mem``/``ctl`` in place (the arena is the largest state
the allocator owns, so a transaction never copies it) and return the
same arena.  All six variants take every path: the plain math picks
``page_alloc`` or ``chunk_alloc`` by kind, the kernels switch on the
kind and family in their arena descriptor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import arena, chunk_alloc, page_alloc, shards
from repro_torch.core.heap import HeapConfig


def _impl(kind: str):
    return page_alloc if kind == "page" else chunk_alloc


def _views(cfg: HeapConfig, kind: str, family: str, mem, ctl):
    lay = arena.layout(cfg, kind, family)
    q, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    return lay, page_alloc.AllocState(q=q, ctx=ctx, meta=meta)


def init(cfg: HeapConfig, kind: str, family: str, device,
         num_shards: int = 1):
    """Fresh arena on ``device``: every chunk queued in the pool, empty
    class queues (a virtualized queue takes one segment per class from
    the pool), and for page kinds each class's share of chunks carved
    into pages and enqueued.  With ``num_shards > 1``, a
    :class:`shards.ShardedArena` of that many identical fresh per-shard
    arenas."""
    if num_shards != 1:
        return shards.init(cfg, num_shards, kind, family, device)
    lay = arena.layout(cfg, kind, family)
    st = arena.blank(lay, device)
    _impl(kind).init(cfg, family, _views(cfg, kind, family, st.mem,
                                         st.ctl)[1])
    return st


def alloc_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
               sizes_bytes, mask, attempt: int = 0) -> Tuple:
    """Plain alloc transaction; updates ``mem``/``ctl`` in place and
    returns ``(mem, ctl, offsets)``.  ``attempt`` is the overflow-walk
    attempt it serves (0 for a single arena): the walk-depth telemetry
    bin of its served lanes."""
    from repro_torch.obs import telemetry
    lay, st = _views(cfg, kind, family, mem, ctl)
    old_ctl = ctl.clone()
    _, offs = _impl(kind).alloc(cfg, family, st, sizes_bytes, mask)
    telemetry.alloc_update(lay, old_ctl, ctl, sizes_bytes, mask, offs,
                           attempt)
    return mem, ctl, offs


def free_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
              offsets_words, sizes_bytes, mask) -> Tuple:
    """Plain free transaction; updates ``mem``/``ctl`` in place."""
    from repro_torch.obs import telemetry
    lay, st = _views(cfg, kind, family, mem, ctl)
    old_ctl = ctl.clone()
    _impl(kind).free(cfg, family, st, offsets_words, sizes_bytes, mask)
    telemetry.free_update(lay, old_ctl, ctl, sizes_bytes, mask,
                          offsets_words)
    return mem, ctl


def grow_lanes(need, lanes: int):
    """Expand a per-slot page-need vector ``(B,)`` into allocation lanes:
    lane ``j`` carries slot ``slot[j]``'s ``rank[j]``-th new page, slots
    packed in slot order, ``mask[j]`` marks live lanes.  Every shape is
    fixed by ``B`` and ``lanes`` and nothing is read back to the host.
    Demand past ``lanes`` is silently truncated: callers compare the
    granted counts against ``need``.

    >>> import torch
    >>> slot, rank, mask = grow_lanes(torch.tensor([2, 0, 1]), lanes=4)
    >>> slot.tolist(), rank.tolist(), mask.tolist()
    ([0, 0, 2, 2], [0, 1, 0, 0], [True, True, True, False])
    """
    need = need.to(torch.int32)
    B = need.shape[0]
    cum = torch.cumsum(need, 0, dtype=torch.int32)
    j = torch.arange(lanes, dtype=torch.int32, device=need.device)
    mask = j < cum[-1]
    slot = torch.clamp(torch.searchsorted(cum, j, right=True, out_int32=True),
                       max=B - 1)
    rank = torch.where(mask, j - (cum[slot] - need[slot]),
                       torch.zeros_like(j))
    return slot, rank, mask


def alloc(cfg: HeapConfig, kind: str, family: str, state: arena.Arena,
          sizes_bytes, mask):
    """One bulk alloc transaction: ``(arena, word offsets)``, −1 for a
    failed lane.  The arena is updated in place."""
    from repro_torch.kernels import ops
    offs = ops.arena_alloc_txn(cfg, kind, family, state.mem, state.ctl,
                               sizes_bytes, mask)
    return state, offs


def free(cfg: HeapConfig, kind: str, family: str, state: arena.Arena,
         offsets_words, sizes_bytes, mask):
    """One bulk free transaction (masked or negative-offset lanes are
    no-ops); the arena is updated in place."""
    from repro_torch.kernels import ops
    ops.arena_free_txn(cfg, kind, family, state.mem, state.ctl,
                       offsets_words, sizes_bytes, mask)
    return state


def compact(cfg: HeapConfig, kind: str, family: str,
            state: arena.Arena) -> arena.Arena:
    """Host-triggered chunk rebind of chunk kinds (``chunk_alloc.compact``:
    fully free chunks back to the pool, queues rebuilt), in place; page
    kinds are left as they are.  It moves no live word (``migrate`` does)
    and is not allocator traffic: the telemetry words pass through."""
    if kind == "chunk":
        chunk_alloc.compact(cfg, family,
                            _views(cfg, kind, family, state.mem,
                                   state.ctl)[1])
    return state


def migrate(cfg: HeapConfig, kind: str, family: str, state: arena.Arena,
            src, dst, sizes) -> arena.Arena:
    """Execute one migration wave (copy extents, flip bitmap bits,
    retire emptied chunks, rebuild queues) in place; a no-op for page
    kinds."""
    from repro_torch.kernels import ops
    if kind != "chunk":
        return state
    ops.arena_defrag_txn(cfg, kind, family, state.mem, state.ctl, src, dst,
                         sizes)
    return state


# ---------------------------------------------------------------------------
# sharded transactions: the serial replay and the dispatchers
# ---------------------------------------------------------------------------
#
# A bulk transaction over S shards behaves exactly as the serial replay
# through S independent single-arena allocators, attempt-major then
# shard-minor:
#
#     for attempt a in 0..walk:
#         for shard s in 0..S-1:
#             serve the still-unserved lanes whose (home + a) % S == s
#
# The plain versions below ARE that replay, in place on the shards'
# row views; the CUDA kernels run the same schedule in one launch.

def sharded_alloc_math(cfg: HeapConfig, num_shards: int, kind: str,
                       family: str, mem, ctl, sizes_bytes, mask, home,
                       walk: int) -> Tuple:
    """Serial replay of one sharded alloc, in place on ``mem``/``ctl``
    (S, ·).  Returns ``(mem, ctl, offsets)`` with GLOBAL offsets (−1 =
    every visited shard failed the lane)."""
    scfg = shards.shard_config(cfg, num_shards)
    Ws = scfg.total_words
    S = num_shards
    offs = torch.full(sizes_bytes.shape, -1, dtype=torch.int32,
                      device=mem.device)
    for a in range(walk + 1):
        for s in range(S):
            sel = mask & ((home + a) % S == s) & (offs < 0)
            _, _, local = alloc_math(scfg, kind, family, mem[s], ctl[s],
                                     sizes_bytes, sel, attempt=a)
            offs = torch.where(sel & (local >= 0), s * Ws + local, offs)
    return mem, ctl, offs


def sharded_free_math(cfg: HeapConfig, num_shards: int, kind: str,
                      family: str, mem, ctl, offsets_words, sizes_bytes,
                      mask) -> Tuple:
    """Serial replay of one sharded free, in place: each lane is freed
    by the shard that owns its global offset, shards in order."""
    scfg = shards.shard_config(cfg, num_shards)
    Ws = scfg.total_words
    sh = torch.where(offsets_words >= 0,
                     torch.div(offsets_words, Ws, rounding_mode="floor"),
                     torch.full_like(offsets_words, -1))
    for s in range(num_shards):
        sel = mask & (sh == s)
        local = torch.where(sel, offsets_words - s * Ws,
                            torch.full_like(offsets_words, -1))
        free_math(scfg, kind, family, mem[s], ctl[s], local, sizes_bytes,
                  sel)
    return mem, ctl


def sharded_alloc(cfg: HeapConfig, num_shards: int, kind: str,
                  family: str, state: shards.ShardedArena, sizes_bytes,
                  mask, home, walk: int):
    """One bulk sharded alloc transaction (one ``sharded_alloc_txn``
    launch on the card); ``home`` is the per-lane home shard
    (``shards.home_shards``).  Returns ``(state, global offsets)``."""
    from repro_torch.kernels import ops
    offs = ops.sharded_arena_alloc_txn(cfg, num_shards, kind, family,
                                       state.mem, state.ctl, sizes_bytes,
                                       mask, home, walk)
    return state, offs


def sharded_free(cfg: HeapConfig, num_shards: int, kind: str, family: str,
                 state: shards.ShardedArena, offsets_words, sizes_bytes,
                 mask):
    """One bulk sharded free transaction (one ``sharded_free_txn``
    launch on the card), in place."""
    from repro_torch.kernels import ops
    ops.sharded_arena_free_txn(cfg, num_shards, kind, family, state.mem,
                               state.ctl, offsets_words, sizes_bytes, mask)
    return state


def sharded_compact(cfg: HeapConfig, num_shards: int, kind: str,
                    family: str,
                    state: shards.ShardedArena) -> shards.ShardedArena:
    """``compact`` of every shard (shards are independent heaps), in
    place."""
    scfg = shards.shard_config(cfg, num_shards)
    for s in range(num_shards):
        compact(scfg, kind, family, shards.take_shard(state, s))
    return state


def sharded_migrate(cfg: HeapConfig, num_shards: int, kind: str,
                    family: str, state: shards.ShardedArena, src, dst,
                    sizes):
    """One sharded migration wave (one ``sharded_defrag_txn`` launch on
    the card), in place: extract every source shard's extents, then
    insert and rebuild every shard.  Cross-shard moves (rebalance) ride
    the same wave.  A no-op for page kinds."""
    from repro_torch.kernels import ops
    if kind != "chunk":
        return state
    ops.sharded_arena_defrag_txn(cfg, num_shards, kind, family, state.mem,
                                 state.ctl, src, dst, sizes)
    return state
