"""Sharded multi-arena allocator: S independent arenas with overflow
routing (port of the reference's ``core/shards.py``).

The heap is partitioned chunk-wise into ``num_shards`` arenas, each
laid out by the same :class:`~repro_torch.core.arena.ArenaLayout` as a
single arena of ``total_bytes / S``:

    ``ShardedArena.mem``  (S, shard mem_words) int32 — row ``s`` is
                          shard ``s``'s word image;
    ``ShardedArena.ctl``  (S, shard ctl_words) int32 — one control
                          block per shard.

Every request lane has a **home shard** (``hash(lane) % S``, or the
caller's ``shard_hint``).  A transaction serves lanes attempt-major,
shard-minor: at step ``(a, s)`` shard ``s`` serves the still-unserved
lanes whose ``(home + a) % S == s``, for ``a`` up to the **overflow
walk** (default all S−1 neighbours).  Offsets are GLOBAL heap word
offsets: ``global = s * shard_words + local``.  That schedule is the
contract: ``transactions.sharded_alloc_math`` replays it serially and
the CUDA kernel ``csrc/alloc_txn.cu`` (``sharded_alloc_txn``) runs it
in one launch.

Everything here is plain tensor ops on the arena's device, with no
host read, except the static layout math.  The reference's
``split_regions``/``join_regions`` exist only for the TPU's
region-blocked lowering and have no counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
import numbers
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import arena
from repro_torch.core.heap import HeapConfig

# Knuth's multiplicative hash constant (2^32 / golden ratio)
_HASH_MULT = 2654435761
_U32 = 0xFFFFFFFF


class ShardedArena(NamedTuple):
    """Stacked per-shard allocator state."""
    mem: Any  # (num_shards, shard mem_words) int32
    ctl: Any  # (num_shards, shard ctl_words) int32

    @property
    def num_shards(self) -> int:
        return self.mem.shape[0]


def shard_config(cfg: HeapConfig, num_shards: int) -> HeapConfig:
    """The per-shard HeapConfig: same chunk/page geometry, 1/S of the
    bytes; shard boundaries are chunk boundaries."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if cfg.num_chunks % num_shards:
        raise ValueError(
            f"num_shards={num_shards} must divide num_chunks="
            f"{cfg.num_chunks} (shards split the heap chunk-wise)")
    return dataclasses.replace(cfg,
                               total_bytes=cfg.total_bytes // num_shards)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Static layout of a sharded arena: ``num_shards`` copies of one
    per-shard ArenaLayout plus the global-offset convention;
    ``describe()`` is the reference's rendering, byte for byte."""
    cfg: HeapConfig            # the GLOBAL heap config
    num_shards: int
    kind: str
    family: str

    @property
    def shard_cfg(self) -> HeapConfig:
        return shard_config(self.cfg, self.num_shards)

    @property
    def shard(self) -> arena.ArenaLayout:
        """The per-shard arena layout (every offset is shard-local)."""
        return arena.layout(self.shard_cfg, self.kind, self.family)

    @property
    def shard_words(self) -> int:
        """Heap words per shard: global offset = s·shard_words + local."""
        return self.shard_cfg.total_words

    @property
    def mem_words(self) -> int:
        return self.shard.mem_words

    @property
    def ctl_words(self) -> int:
        return self.shard.ctl_words

    def describe(self, blocks: bool = False) -> str:
        S = self.num_shards
        lines = [
            f"sharded arena(kind={self.kind}, family={self.family}, "
            f"num_shards={S}): mem {S}x{self.mem_words} words, "
            f"ctl {S}x{self.ctl_words} words",
            f"  global heap offset = shard * {self.shard_words} + local; "
            f"home = hash(lane) % {S} or shard_hint; overflow walk "
            f"retries home+1..home+{S - 1} (mod {S})",
        ]
        lines += ["  " + ln
                  for ln in self.shard.describe(blocks=blocks).splitlines()]
        return "\n".join(lines)


@functools.lru_cache(maxsize=None)
def layout(cfg: HeapConfig, num_shards: int, kind: str,
           family: str) -> ShardLayout:
    arena.layout(shard_config(cfg, num_shards), kind, family)
    return ShardLayout(cfg=cfg, num_shards=num_shards, kind=kind,
                       family=family)


def resolve_walk(num_shards: int, overflow_walk: Optional[int]) -> int:
    """How many neighbour shards a lane may retry after its home shard
    fails; ``None`` = all S−1."""
    if overflow_walk is None:
        return num_shards - 1
    if not isinstance(overflow_walk, int) or overflow_walk < 0:
        raise ValueError(
            f"overflow_walk must be None or an int >= 0, got "
            f"{overflow_walk!r}")
    return min(overflow_walk, num_shards - 1)


def static_hint(shard_hint) -> Optional[int]:
    """``shard_hint`` as a Python int when it is one (numpy integer
    scalars included), else None: whether the pinned fast path can
    apply."""
    if shard_hint is None or isinstance(shard_hint, bool):
        return None
    if isinstance(shard_hint, numbers.Integral):
        return int(shard_hint)
    return None


def home_shards(n: int, num_shards: int, shard_hint=None, device="cpu"):
    """(n,) int32 home shard per lane: ``None`` hashes the lane index
    (in uint32 arithmetic, done in int64 masked to 32 bits), an integer
    pins every lane to one shard, an array gives per-lane homes (floor
    modulo S, so negative hints wrap)."""
    if shard_hint is None:
        i = torch.arange(n, dtype=torch.int64, device=device)
        h = (i * _HASH_MULT) & _U32
        h = h ^ (h >> 16)
        return (h % num_shards).to(torch.int32)
    pinned = static_hint(shard_hint)
    if pinned is not None:
        return torch.full((n,), pinned % num_shards, dtype=torch.int32,
                          device=device)
    hint = torch.as_tensor(shard_hint, device=device).to(torch.int32)
    if tuple(hint.shape) != (n,):
        raise ValueError(f"shard_hint array must have shape ({n},), got "
                         f"{tuple(hint.shape)}")
    return hint % num_shards


def init(cfg: HeapConfig, num_shards: int, kind: str, family: str,
         device) -> ShardedArena:
    """S identical fresh shards, each initialised like a single arena
    of the per-shard config."""
    from repro_torch.core import transactions  # shards <-> transactions
    sub = transactions.init(shard_config(cfg, num_shards), kind, family,
                            device)
    return ShardedArena(mem=sub.mem[None].repeat(num_shards, 1),
                        ctl=sub.ctl[None].repeat(num_shards, 1))


# --------------------------------------------------------------------------
# views: global heap, per-shard slabs
# --------------------------------------------------------------------------

def heap_of(slay: ShardLayout, state: ShardedArena):
    """The GLOBAL heap (S·shard_words,): the per-shard heaps in shard
    order, so global word offsets index it (a copy: the rows are not
    adjacent in ``mem``)."""
    return state.mem[:, :slay.shard_words].reshape(-1)


def with_heap(slay: ShardLayout, state: ShardedArena,
              heap) -> ShardedArena:
    """Write a global heap back into the shards (inverse of
    :func:`heap_of`), in place."""
    state.mem[:, :slay.shard_words] = heap.reshape(slay.num_shards, -1)
    return state


def shard_of(slay: ShardLayout, offsets_words):
    """Owning shard of each global offset (−1 for failed lanes)."""
    return torch.where(offsets_words >= 0,
                       torch.div(offsets_words, slay.shard_words,
                                 rounding_mode="floor"),
                       torch.full_like(offsets_words, -1))


def take_shard(state: ShardedArena, s: int) -> arena.Arena:
    """Shard ``s`` as a single-arena state: views of its rows, so a
    single-arena transaction on it updates the sharded arena in
    place."""
    return arena.Arena(mem=state.mem[s], ctl=state.ctl[s])


def with_shard(state: ShardedArena, s: int,
               sub: arena.Arena) -> ShardedArena:
    """Replace one shard's slab (in place; a no-op for the views that
    :func:`take_shard` returns)."""
    if sub.mem.data_ptr() != state.mem[s].data_ptr():
        state.mem[s] = sub.mem
    if sub.ctl.data_ptr() != state.ctl[s].data_ptr():
        state.ctl[s] = sub.ctl
    return state


# --------------------------------------------------------------------------
# cross-shard rebalancing: plan moves from the most- to the least-loaded
# --------------------------------------------------------------------------

def _region_rows(lay: arena.ArenaLayout, mem, name: str):
    r = lay.region(name)
    return mem[:, r.offset:r.end]


def shard_live_words(cfg: HeapConfig, num_shards: int, kind: str,
                     family: str, mem, ctl):
    """(S,) int32 live heap words per shard (the occupied pages of its
    bound chunks): the load the rebalance plan compares.  Zero for page
    kinds."""
    if kind != "chunk":
        return torch.zeros(num_shards, dtype=torch.int32, device=mem.device)
    scfg = shard_config(cfg, num_shards)
    lay = arena.layout(scfg, kind, family)
    C = scfg.num_classes
    cc_raw = _region_rows(lay, mem, "chunk_class").to(torch.int64)
    fc = _region_rows(lay, mem, "free_count").to(torch.int64)
    cc = torch.clamp(cc_raw, 0, C - 1)
    ppc = scfg.max_pages_per_chunk >> cc
    pw = scfg.page_words(0) << cc
    live = torch.where(cc_raw >= 0, (ppc - fc) * pw, torch.zeros_like(fc))
    return live.sum(1).to(torch.int32)


def rebalance_plan_math(cfg: HeapConfig, num_shards: int, kind: str,
                        family: str, mem, ctl, *, max_moves: int):
    """Cross-shard relocation plan: move live pages from the most-loaded
    shard's sparsest chunks into free slots of the least-loaded shard's
    densest bound chunks (then its pool chunks, claimed on insert),
    class by class, until half the load gap is closed or the table
    fills.  Returns ``(src, dst, sizes)`` GLOBAL word offsets, −1
    padded; executed by the same sharded wave as the in-shard plan.
    Ties in the load pick the lowest shard id (first index)."""
    from repro_torch.core import defrag as _defrag  # shards <-> defrag
    dev = mem.device
    if kind != "chunk":
        f = _defrag.empty_forwarding(max_moves, dev)
        return f.src, f.dst, f.sizes
    scfg = shard_config(cfg, num_shards)
    lay = arena.layout(scfg, kind, family)
    C = scfg.num_classes
    nc = scfg.num_chunks
    wpc = scfg.words_per_chunk
    Ws = scfg.total_words
    maxbits = scfg.bitmap_words_per_chunk * 32
    ids = torch.arange(nc, dtype=torch.int64, device=dev)
    bitpos = torch.arange(maxbits, dtype=torch.int64, device=dev)

    live_w = shard_live_words(cfg, num_shards, kind, family, mem,
                              ctl).to(torch.int64)
    donor = torch.argmax(live_w)
    recv = torch.argmin(live_w)
    budget_words = torch.clamp((live_w.max() - live_w.min()) // 2, min=0)

    def views_of(s):
        row = s.view(1)
        _, ctx, meta = arena.unpack(lay, arena.Arena(
            torch.index_select(mem, 0, row)[0],
            torch.index_select(ctl, 0, row)[0]))
        return ctx, meta

    (_, dm), (rctx, rm) = views_of(donor), views_of(recv)
    d_occ = _defrag._occupancy_bits(dm.bitmap)
    r_occ = _defrag._occupancy_bits(rm.bitmap)
    r_pool = _defrag._pool_members(scfg, rctx.pool)
    d_fc = dm.free_count.to(torch.int64)
    r_fc = rm.free_count.to(torch.int64)

    def table(fill):
        return torch.full((max_moves + 1,), fill, dtype=torch.int32,
                          device=dev)

    src, dst, sz = table(-1), table(-1), table(0)
    base = torch.zeros((), dtype=torch.int64, device=dev)
    k = torch.arange(max_moves, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(d_fc)
    for c in range(C):
        ppc = scfg.pages_per_chunk(c)
        pw = scfg.page_words(c)
        in_range = bitpos[None, :] < ppc
        d_bound = dm.chunk_class == c
        r_bound = rm.chunk_class == c
        d_live = torch.where(d_bound, ppc - d_fc, zero)
        r_live = torch.where(r_bound, ppc - r_fc, zero)
        # donor pages from its sparsest chunks first; receiver slots
        # densest-bound-first, then pool chunks in id order (unique keys)
        d_key = torch.where(d_bound, d_live * nc + ids, (ppc + 1) * nc + ids)
        r_key = torch.where(r_bound, (ppc - r_live) * nc + ids,
                            torch.where(r_pool, (ppc + 1) * nc + ids,
                                        (ppc + 2) * nc + ids))
        d_order = torch.argsort(d_key, stable=True)
        r_order = torch.argsort(r_key, stable=True)
        src_bits = d_occ & d_bound[:, None] & in_range
        dst_bits = (((~r_occ) & r_bound[:, None])
                    | r_pool[:, None]) & in_range
        avail = torch.minimum(src_bits.sum(), dst_bits.sum())
        budget = torch.minimum(budget_words // pw, avail)
        budget = torch.minimum(torch.clamp(budget, min=0), max_moves - base)
        off_of = ids[:, None] * wpc + bitpos[None, :] * pw
        s_off, cnt = _defrag._take_bits(src_bits, d_order, budget, off_of,
                                        max_moves)
        d_off, _ = _defrag._take_bits(dst_bits, r_order, budget, off_of,
                                      max_moves)
        pos = torch.where(k < cnt, base + k, max_moves)
        src.scatter_(0, pos, (s_off + donor * Ws).to(torch.int32))
        dst.scatter_(0, pos, (d_off + recv * Ws).to(torch.int32))
        sz.scatter_(0, pos, torch.full_like(s_off, scfg.page_bytes(c)))
        base = base + cnt
        budget_words = budget_words - cnt * pw
        # a pool chunk claimed by this class is not offered to a later
        # class in the same wave (one chunk, one page size)
        used = torch.zeros(nc + 1, dtype=torch.bool, device=dev)
        used.scatter_(0, torch.where((k < cnt) & (d_off >= 0),
                                     d_off.to(torch.int64) // wpc, nc),
                      True)
        r_pool = r_pool & ~used[:nc]
    # a shard never rebalances onto itself
    noop = donor == recv
    src = torch.where(noop, -1, src[:max_moves])
    dst = torch.where(noop, -1, dst[:max_moves])
    sz = torch.where(noop, 0, sz[:max_moves])
    return src, dst, sz
