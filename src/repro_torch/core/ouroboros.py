"""Ouroboros allocator facade (port).

    ouro = Ouroboros(cfg, "vl_chunk", device="cuda")
    state = ouro.init()                                   # core.arena.Arena
    state, offs = ouro.alloc(state, sizes_bytes, mask)    # offs in words
    state, offs, slot, rank, mask = ouro.grow(state, need, 256, lanes)
    state = ouro.free(state, offs, sizes_bytes, mask)
    state, fwd = ouro.defrag(state)                       # one wave
    state = ouro.write_pattern(state, offs, sizes_bytes, tag)  # data path
    ok = ouro.check_pattern(state, offs, sizes_bytes, tag)

The six variants of the paper (its figures 1-6) are ``page``/``chunk``
(plain ring queues) and ``va_*``/``vl_*`` (virtualized array and list
queues) of pages or of chunks with occupancy bitmaps; all six run every
path below.

Unlike the reference there is no ``backend``/``lowering`` knob: an
arena on the card runs every transaction as one CUDA kernel launch
(``csrc/alloc_txn.cu``, ``csrc/defrag_txn.cu``), an arena on the CPU
runs the plain PyTorch math.  Both give the same words.  Transactions
and waves update the arena in place and return it.

With ``num_shards > 1`` the heap is partitioned into that many
independent arenas (``core/shards.py``): the state is a
``shards.ShardedArena``, each lane routes to a home shard (hashed, or
``shard_hint``) with a bounded overflow walk to its neighbours, offsets
are global, and each transaction or wave is still one kernel launch
(``sharded_alloc_txn``, ``sharded_free_txn``, ``sharded_defrag_txn``).
``rebalance`` moves live pages from the most- to the least-loaded
shard through the same wave.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import arena, defrag as _defrag, shards, transactions
from repro_torch.core._index import gather_fill, scatter_drop_
from repro_torch.core.heap import HeapConfig
from repro_torch.device import resolve_device

VARIANTS = ("page", "chunk", "va_page", "vl_page", "va_chunk", "vl_chunk")


def _split(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    if variant in ("page", "chunk"):
        return variant, "ring"
    fam, kind = variant.split("_")
    return kind, fam


@dataclasses.dataclass(frozen=True)
class Ouroboros:
    """Binds a HeapConfig to one paper variant on one device.
    ``num_shards > 1`` partitions the heap into independent arenas;
    ``overflow_walk`` bounds how many neighbour shards a lane may retry
    after its home shard fails (``None`` = all of them)."""
    cfg: HeapConfig
    variant: str
    device: str = "cuda"
    num_shards: int = 1
    overflow_walk: Optional[int] = None

    def __post_init__(self):
        kind, family = _split(self.variant)
        if self.num_shards != 1:
            shards.layout(self.cfg, self.num_shards, kind, family)
            shards.resolve_walk(self.num_shards, self.overflow_walk)
        elif self.overflow_walk is not None:
            raise ValueError("overflow_walk requires num_shards > 1")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def kind(self) -> str:
        return _split(self.variant)[0]

    @property
    def family(self) -> str:
        return _split(self.variant)[1]

    @property
    def walk(self) -> int:
        """Resolved overflow-walk length (0 when unsharded)."""
        if self.num_shards == 1:
            return 0
        return shards.resolve_walk(self.num_shards, self.overflow_walk)

    @property
    def layout(self):
        """An ``arena.ArenaLayout``, or a ``shards.ShardLayout`` when
        sharded."""
        if self.num_shards == 1:
            return arena.layout(self.cfg, self.kind, self.family)
        return shards.layout(self.cfg, self.num_shards, self.kind,
                             self.family)

    @property
    def shard_cfg(self) -> HeapConfig:
        return shards.shard_config(self.cfg, self.num_shards)

    def init(self):
        return transactions.init(self.cfg, self.kind, self.family,
                                 self.device, self.num_shards)

    # -- transactions ---------------------------------------------------------

    def alloc(self, state, sizes_bytes, mask, shard_hint=None):
        """One bulk allocation: ``(state, word offsets)``; −1 marks a
        failed lane (over-large size or exhausted heap).  Sharded:
        ``shard_hint`` None hashes each lane to a home shard, an int or
        a per-lane array pins homes; a static int with
        ``overflow_walk=0`` serves every lane from that shard alone
        (the pinned fast path: the other shards' steps select no lane,
        so the transaction skips them)."""
        if self.num_shards == 1:
            if shard_hint is not None:
                raise ValueError("shard_hint requires num_shards > 1")
            return transactions.alloc(self.cfg, self.kind, self.family,
                                      state, sizes_bytes, mask)
        home = shards.home_shards(sizes_bytes.shape[0], self.num_shards,
                                  shard_hint, device=sizes_bytes.device)
        return transactions.sharded_alloc(
            self.cfg, self.num_shards, self.kind, self.family, state,
            sizes_bytes, mask, home, self.walk)

    def grow(self, state, need, size_bytes: int, lanes: int, home=None):
        """The decode mega-step's transaction: grant each slot ``b`` its
        ``need[b]`` new ``size_bytes`` regions, ``need`` a per-slot
        vector ``(B,)`` on the arena's device.  Lanes come from
        ``transactions.grow_lanes`` (slot-major, as the host loop
        issues them); the grant is ONE ordinary alloc transaction (one
        ``alloc_txn`` or ``sharded_alloc_txn`` launch on the card), so
        nothing is read back to the host.  ``home`` (sharded only) gives
        each slot's home shard ``(B,)``; None homes slot ``b`` on
        ``b % num_shards``.  Returns ``(state, lane offsets, lane slot,
        lane rank, lane mask)``; offset −1 marks a failed or masked
        lane."""
        lane_slot, lane_rank, lane_mask = transactions.grow_lanes(need,
                                                                  lanes)
        sizes = torch.full((lanes,), size_bytes, dtype=torch.int32,
                           device=need.device)
        if self.num_shards == 1:
            if home is not None:
                raise ValueError("home requires num_shards > 1")
            state, offs = transactions.alloc(self.cfg, self.kind,
                                             self.family, state, sizes,
                                             lane_mask)
        else:
            if home is None:
                home = torch.arange(need.shape[0], dtype=torch.int32,
                                    device=need.device)
            lane_home = (home.to(torch.int32) % self.num_shards)[lane_slot]
            state, offs = transactions.sharded_alloc(
                self.cfg, self.num_shards, self.kind, self.family, state,
                sizes, lane_mask, lane_home, self.walk)
        return state, offs, lane_slot, lane_rank, lane_mask

    def free(self, state, offsets_words, sizes_bytes, mask,
             shard_hint=None):
        """One bulk free (offsets as ``alloc`` returned them; a sharded
        offset is owned by exactly one shard).  A static int
        ``shard_hint`` with ``overflow_walk=0`` frees on that shard
        alone; lanes whose offsets live elsewhere are dropped."""
        if self.num_shards == 1:
            if shard_hint is not None:
                raise ValueError("shard_hint requires num_shards > 1")
            return transactions.free(self.cfg, self.kind, self.family,
                                     state, offsets_words, sizes_bytes,
                                     mask)
        pinned = shards.static_hint(shard_hint)
        if pinned is not None and self.walk == 0:
            mask = mask & (shards.shard_of(self.layout, offsets_words)
                           == pinned % self.num_shards)
        return transactions.sharded_free(
            self.cfg, self.num_shards, self.kind, self.family, state,
            offsets_words, sizes_bytes, mask)

    def compact(self, state):
        """Chunk rebind of chunk kinds (fully free chunks back to the
        pool, queues rebuilt; every shard when sharded), in place; page
        kinds are left as they are.  No live word moves."""
        if self.num_shards == 1:
            return transactions.compact(self.cfg, self.kind, self.family,
                                        state)
        return transactions.sharded_compact(
            self.cfg, self.num_shards, self.kind, self.family, state)

    def heap(self, state):
        """The heap proper: a view into ``state.mem`` for one arena; for
        a sharded arena the shards' heaps concatenated in shard order (a
        copy), so global offsets index it."""
        if self.num_shards == 1:
            return arena.heap_of(self.layout, state)
        return shards.heap_of(self.layout, state)

    def _with_heap(self, state, heap):
        if self.num_shards == 1:
            return arena.with_heap(self.layout, state, heap)
        return shards.with_heap(self.layout, state, heap)

    # -- the paper's data path: write some data, check it reads back -----

    def write_pattern(self, state, offsets_words, sizes_bytes, tag):
        """Fill every granted extent with its lane's ``tag`` word, in
        place; returns the state."""
        heap = write_words(self.cfg, self.heap(state), offsets_words,
                           sizes_bytes, tag)
        return self._with_heap(state, heap)

    def check_pattern(self, state, offsets_words, sizes_bytes, tag):
        """Per lane: granted, and every word of its extent still holds
        its tag (an overlapping grant breaks this)."""
        return check_words(self.cfg, self.heap(state), offsets_words,
                           sizes_bytes, tag)

    def frag_stats(self, state):
        """``free_words``, ``largest_free_extent`` and ``frag_ratio``
        (``1 − largest/total``) of ``state``: Python numbers, or lists of
        S of them (one per shard) when sharded."""
        if self.num_shards == 1:
            free, largest = _defrag.frag_stats_math(
                self.cfg, self.kind, self.family, state.mem, state.ctl)
            return {"free_words": int(free),
                    "largest_free_extent": int(largest),
                    "frag_ratio": _defrag.frag_ratio(free, largest)}
        pairs = [_defrag.frag_stats_math(self.shard_cfg, self.kind,
                                         self.family, state.mem[s],
                                         state.ctl[s])
                 for s in range(self.num_shards)]
        return {"free_words": [int(f) for f, _ in pairs],
                "largest_free_extent": [int(lg) for _, lg in pairs],
                "frag_ratio": [_defrag.frag_ratio(f, lg) for f, lg in pairs]}

    # -- defragmentation (core/defrag.py) ------------------------------------

    def _moves(self, max_moves) -> int:
        if max_moves is None:
            max_moves = min(_defrag.DEFAULT_MAX_MOVES,
                            self.cfg.num_chunks
                            * self.cfg.max_pages_per_chunk)
        if not isinstance(max_moves, int) or max_moves < 1:
            raise ValueError(
                f"max_moves must be a positive int, got {max_moves!r}")
        return max_moves

    def defrag(self, state, max_moves=None):
        """One defragmentation wave: the plan on the arena's device, then
        the migration as ONE execute step (one ``defrag_txn`` launch on
        the card, ``sharded_defrag_txn`` when sharded), in place.
        Returns ``(state, forwarding)``: the old→new
        :class:`~repro_torch.core.defrag.Forwarding` table that callers
        remap held offsets through (``defrag.forward_offsets``,
        ``kv_cache.apply_forwarding``).  A sharded arena compacts every
        shard in the same wave; cross-shard moves are :meth:`rebalance`'s
        job.  Page kinds bind no chunks: their plan is empty and the
        wave leaves the arena as it is."""
        M = self._moves(max_moves)
        if self.num_shards == 1:
            src, dst, sizes = _defrag.plan_math(
                self.cfg, self.kind, self.family, state.mem, state.ctl,
                max_moves=M)
            state = transactions.migrate(self.cfg, self.kind, self.family,
                                         state, src, dst, sizes)
        else:
            src, dst, sizes = _defrag.sharded_plan_math(
                self.cfg, self.num_shards, self.kind, self.family,
                state.mem, state.ctl, max_moves=M)
            state = transactions.sharded_migrate(
                self.cfg, self.num_shards, self.kind, self.family, state,
                src, dst, sizes)
        return state, _defrag.Forwarding(src=src, dst=dst, sizes=sizes)

    def rebalance(self, state, max_moves=None):
        """One cross-shard rebalance wave (sharded arenas only): the
        plan of ``shards.rebalance_plan_math`` (most- to least-loaded
        shard), executed by the same one-launch wave as :meth:`defrag`.
        Returns ``(state, forwarding)`` with GLOBAL offsets."""
        if self.num_shards == 1:
            raise ValueError("rebalance requires num_shards > 1")
        M = self._moves(max_moves)
        src, dst, sizes = shards.rebalance_plan_math(
            self.cfg, self.num_shards, self.kind, self.family, state.mem,
            state.ctl, max_moves=M)
        state = transactions.sharded_migrate(
            self.cfg, self.num_shards, self.kind, self.family, state, src,
            dst, sizes)
        return state, _defrag.Forwarding(src=src, dst=dst, sizes=sizes)


def _word_grid(cfg: HeapConfig, offsets_words, sizes_bytes):
    """(n, words_per_chunk) heap word indices of each lane's extent, and
    which of them belong to it (a granted lane's first size/4 words)."""
    maxw = cfg.words_per_chunk  # largest page
    nw = torch.clamp(torch.div(sizes_bytes, 4, rounding_mode="floor"),
                     min=1).to(torch.int32)
    j = torch.arange(maxw, dtype=torch.int32,
                     device=offsets_words.device)[None, :]
    ok = (j < nw[:, None]) & (offsets_words[:, None] >= 0)
    return offsets_words[:, None] + j, ok


def write_words(cfg: HeapConfig, heap, offsets_words, sizes_bytes, tag):
    """Write ``tag[i]`` over lane i's extent of ``heap`` (the heap view,
    ``cfg.total_words`` long), in place; words past its end are
    dropped.  Returns ``heap``."""
    words, ok = _word_grid(cfg, offsets_words, sizes_bytes)
    vals = torch.broadcast_to(tag.to(torch.int32)[:, None], words.shape)
    W = heap.shape[0]
    return scatter_drop_(heap, torch.where(ok, words, W).reshape(-1),
                         vals.reshape(-1))


def check_words(cfg: HeapConfig, heap, offsets_words, sizes_bytes, tag):
    """Per lane (bool): granted, and every word of its extent holds
    ``tag[i]``; a word past the heap's end reads −1."""
    words, ok = _word_grid(cfg, offsets_words, sizes_bytes)
    got = gather_fill(heap, words.reshape(-1), -1).reshape(words.shape)
    good = torch.where(ok, got == tag.to(torch.int32)[:, None], True)
    return good.all(1) & (offsets_words >= 0)
