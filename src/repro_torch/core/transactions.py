"""Allocator transactions over the device-resident arena (port).

Every variant is a ``(kind, family)`` pair and every transaction runs
against one :class:`arena.Arena`.  Two paths share one contract:

``alloc_math`` / ``free_math``  the plain PyTorch transaction: unpack
    the arena into views, run ``chunk_alloc`` and the telemetry update,
    all in place.  The CPU path and the parity tests run it.

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

Both update ``mem``/``ctl`` in place (the arena is the largest state
the allocator owns, so a transaction never copies it) and return the
same arena.  Only ``(chunk, vl)`` is ported; the other five variants
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import arena, chunk_alloc, shards
from repro_torch.core.heap import HeapConfig

PORTED = (("chunk", "vl"),)


def check_variant(kind: str, family: str) -> None:
    if (kind, family) in PORTED:
        return
    item = "A3" if kind == "chunk" else "A3 (page kinds)"
    raise NotImplementedError(
        f"allocator variant (kind={kind}, family={family}) is not ported "
        f"yet (ROADMAP {item}); the port serves (chunk, vl)")


def _views(cfg: HeapConfig, kind: str, family: str, mem, ctl):
    lay = arena.layout(cfg, kind, family)
    q, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    return lay, chunk_alloc.AllocState(q=q, ctx=ctx, meta=meta)


def init(cfg: HeapConfig, kind: str, family: str, device,
         num_shards: int = 1):
    """Fresh arena on ``device``: every chunk queued in the pool, then
    one empty vl segment per class popped from it.  With
    ``num_shards > 1``, a :class:`shards.ShardedArena` of that many
    identical fresh per-shard arenas."""
    if num_shards != 1:
        return shards.init(cfg, num_shards, kind, family, device)
    check_variant(kind, family)
    lay = arena.layout(cfg, kind, family)
    st = arena.blank(lay, device)
    chunk_alloc.init(cfg, family, _views(cfg, kind, family, st.mem,
                                         st.ctl)[1])
    return st


def alloc_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
               sizes_bytes, mask, attempt: int = 0) -> Tuple:
    """Plain alloc transaction; updates ``mem``/``ctl`` in place and
    returns ``(mem, ctl, offsets)``.  ``attempt`` is the overflow-walk
    attempt it serves (0 for a single arena): the walk-depth telemetry
    bin of its served lanes."""
    from repro_torch.obs import telemetry
    check_variant(kind, family)
    lay, st = _views(cfg, kind, family, mem, ctl)
    old_ctl = ctl.clone()
    _, offs = chunk_alloc.alloc(cfg, family, st, sizes_bytes, mask)
    telemetry.alloc_update(lay, old_ctl, ctl, sizes_bytes, mask, offs,
                           attempt)
    return mem, ctl, offs


def free_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
              offsets_words, sizes_bytes, mask) -> Tuple:
    """Plain free transaction; updates ``mem``/``ctl`` in place."""
    from repro_torch.obs import telemetry
    check_variant(kind, family)
    lay, st = _views(cfg, kind, family, mem, ctl)
    old_ctl = ctl.clone()
    chunk_alloc.free(cfg, family, st, offsets_words, sizes_bytes, mask)
    telemetry.free_update(lay, old_ctl, ctl, sizes_bytes, mask,
                          offsets_words)
    return mem, ctl


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
