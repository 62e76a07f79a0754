"""Device-resident arena: the whole allocator state as two flat int32
tensors (port of the reference's ``core/arena.py``).

``mem`` holds, at fixed word offsets, the heap proper, the free-chunk
pool ring, the class queue ring or segment directory, and (chunk kinds)
the occupancy bitmaps, free counts and chunk→class bindings.  ``ctl``
holds every counter (per-class front/back/head/tail, the pool's
front/back) followed by the telemetry region.

Offsets are static functions of ``(HeapConfig, kind, family)``; the
layout math and ``describe()`` are the reference's, byte for byte
(``tests/test_torch_alloc.py`` pins them to
``tests/golden/arena_layout.txt``).  ``Region.blocking`` records how
the reference's region-blocked TPU lowering stages each region; the
port has a single CUDA lowering and keeps the field only so the
rendering matches.

``unpack`` returns *views* into ``mem``/``ctl``: transactions update
the arena in place.  Bitmaps stay int32 words (the reference bitcasts
them to uint32); the bit arithmetic masks to 32 bits instead.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import queues
from repro_torch.core.heap import HeapConfig

KINDS = ("page", "chunk")
QUEUE_FAMILIES = ("ring", "va", "vl")

# Overflow-walk depth histogram width in the ctl telemetry region.
TELE_WALK_BINS = 8


class Arena(NamedTuple):
    mem: Any  # (layout.mem_words,) int32
    ctl: Any  # (layout.ctl_words,) int32


class ChunkMeta(NamedTuple):
    bitmap: Any       # (num_chunks, bitmap_words) int32 words, 1 = in use
    free_count: Any   # (num_chunks,) int32
    chunk_class: Any  # (num_chunks,) int32, -1 = unbound


@dataclasses.dataclass(frozen=True)
class Region:
    """One named window of ``mem``: ``[offset, offset + words)``."""
    name: str
    offset: int
    shape: Tuple[int, ...]
    blocking: str = "resident"

    @property
    def words(self) -> int:
        return math.prod(self.shape)

    @property
    def end(self) -> int:
        return self.offset + self.words

    @property
    def block_shape(self) -> Optional[Tuple[int, ...]]:
        if self.blocking == "row":
            return (1,) + self.shape[1:]
        if self.blocking == "resident":
            return self.shape
        return None


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Static word layout of one (cfg, kind, family) arena."""
    cfg: HeapConfig
    kind: str
    family: str
    regions: Tuple[Region, ...]
    num_classes: int
    queue_capacity: int
    max_segs: int

    @property
    def mem_words(self) -> int:
        return self.regions[-1].end

    @property
    def core_ctl_words(self) -> int:
        return 4 * self.num_classes + 2

    @property
    def tele_words(self) -> int:
        return 4 * self.num_classes + 3 + TELE_WALK_BINS

    @property
    def ctl_words(self) -> int:
        return self.core_ctl_words + self.tele_words

    def region(self, name: str) -> Region:
        for r in self.regions:
            if r.name == name:
                return r
        raise KeyError(f"arena({self.kind},{self.family}) has no region "
                       f"{name!r}")

    def has(self, name: str) -> bool:
        return any(r.name == name for r in self.regions)

    @property
    def off_front(self) -> int:
        return 0

    @property
    def off_back(self) -> int:
        return self.num_classes

    @property
    def off_head(self) -> int:
        return 2 * self.num_classes

    @property
    def off_tail(self) -> int:
        return 3 * self.num_classes

    @property
    def off_pool_front(self) -> int:
        return 4 * self.num_classes

    @property
    def off_pool_back(self) -> int:
        return 4 * self.num_classes + 1

    @property
    def off_t_alloc(self) -> int:
        return self.core_ctl_words

    @property
    def off_t_free(self) -> int:
        return self.off_t_alloc + self.num_classes

    @property
    def off_t_fail(self) -> int:
        return self.off_t_free + self.num_classes

    @property
    def off_t_wrap(self) -> int:
        return self.off_t_fail + self.num_classes

    @property
    def off_t_grow(self) -> int:
        return self.off_t_wrap + self.num_classes

    @property
    def off_t_shrink(self) -> int:
        return self.off_t_grow + 1

    @property
    def off_t_pool_wrap(self) -> int:
        return self.off_t_shrink + 1

    @property
    def off_t_walk(self) -> int:
        return self.off_t_pool_wrap + 1

    def tele_fields(self) -> Tuple[Tuple[str, int, int], ...]:
        """(name, ctl offset, words) rows of the telemetry region."""
        C = self.num_classes
        return (("t_alloc", self.off_t_alloc, C),
                ("t_free", self.off_t_free, C),
                ("t_fail", self.off_t_fail, C),
                ("t_wrap", self.off_t_wrap, C),
                ("t_grow", self.off_t_grow, 1),
                ("t_shrink", self.off_t_shrink, 1),
                ("t_pool_wrap", self.off_t_pool_wrap, 1),
                ("t_walk", self.off_t_walk, TELE_WALK_BINS))

    @property
    def wrap_capacity(self) -> int:
        """Queue positions per full turn of a class queue."""
        if self.family == "ring":
            return self.queue_capacity
        return self.max_segs * self.cfg.slots_per_segment(self.family)

    def describe(self, blocks: bool = False) -> str:
        """Human-readable offset table (identical to the reference's)."""
        lines = [f"arena(kind={self.kind}, family={self.family}): "
                 f"mem {self.mem_words} words, ctl {self.ctl_words} words"]
        for r in self.regions:
            tail = ""
            if blocks:
                bs = ("-" if r.block_shape is None
                      else "x".join(map(str, r.block_shape)))
                tail = f"  [{r.blocking}: block {bs}]"
            lines.append(f"  mem[{r.offset}:{r.end}]  {r.name} {r.shape}"
                         f"{tail}")
        C = self.num_classes
        for nm, off, w in (("front", self.off_front, C),
                           ("back", self.off_back, C),
                           ("head", self.off_head, C),
                           ("tail", self.off_tail, C),
                           ("pool_front", self.off_pool_front, 1),
                           ("pool_back", self.off_pool_back, 1)):
            lines.append(f"  ctl[{off}:{off + w}]  {nm}")
        for nm, off, w in self.tele_fields():
            lines.append(f"  ctl[{off}:{off + w}]  {nm}")
        return "\n".join(lines)


def queue_capacity(cfg: HeapConfig, kind: str) -> int:
    if kind == "page":
        return cfg.data_chunks_per_class * cfg.pages_per_chunk(0)
    return cfg.num_chunks


@functools.lru_cache(maxsize=None)
def layout(cfg: HeapConfig, kind: str, family: str) -> ArenaLayout:
    """Static arena layout for one allocator variant (all six)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; pick from {KINDS}")
    if family not in QUEUE_FAMILIES:
        raise ValueError(
            f"unknown family {family!r}; pick from {QUEUE_FAMILIES}")
    C = cfg.num_classes
    cap = queue_capacity(cfg, kind)
    max_segs = cap // cfg.slots_per_segment(family) + 2
    heap_blk = "untouched" if family == "ring" else "hbm"
    pool_blk = ("untouched" if (family == "ring" and kind == "page")
                else "resident")
    regions = [Region("heap", 0, (cfg.total_words,), heap_blk)]

    def add(name, shape, blocking):
        regions.append(Region(name, regions[-1].end, shape, blocking))

    add("pool_store", (1, cfg.num_chunks), pool_blk)
    if family == "ring":
        add("queue_store", (C, cap), "row")
    else:
        add("directory", (C, max_segs), "row")
    if kind == "chunk":
        add("bitmap", (cfg.num_chunks, cfg.bitmap_words_per_chunk), "hbm")
        add("free_count", (cfg.num_chunks,), "resident")
        add("chunk_class", (cfg.num_chunks,), "resident")
    return ArenaLayout(cfg=cfg, kind=kind, family=family,
                       regions=tuple(regions), num_classes=C,
                       queue_capacity=cap, max_segs=max_segs)


# --------------------------------------------------------------------------
# pack / unpack: arena words <-> the view tuples
# --------------------------------------------------------------------------

def _take(lay: ArenaLayout, mem, name: str):
    r = lay.region(name)
    return mem[r.offset:r.end].view(r.shape)


def tele_of(lay: ArenaLayout, ctl):
    """View of the telemetry region inside one ctl block."""
    return ctl[lay.core_ctl_words:lay.ctl_words]


def heap_of(lay: ArenaLayout, arena: Arena):
    """View of the heap proper inside ``mem``."""
    return arena.mem[:lay.cfg.total_words]


def with_heap(lay: ArenaLayout, arena: Arena, heap) -> Arena:
    """Write ``heap`` over the heap region of ``arena.mem`` (offset 0),
    in place, and return the arena (nothing to copy when ``heap`` is
    the view :func:`heap_of` returns)."""
    if heap.data_ptr() != arena.mem.data_ptr():
        arena.mem[:lay.cfg.total_words] = heap
    return arena


def pack(lay: ArenaLayout, q, ctx: queues.AllocCtx,
         meta: Optional[ChunkMeta], tele=None) -> Arena:
    """Concatenate view tuples into a fresh (mem, ctl) arena; ``tele``
    None zeroes the telemetry region."""
    C = lay.num_classes
    dev = ctx.heap.device
    parts = [ctx.heap, ctx.pool.store.reshape(-1)]
    if lay.family == "ring":
        parts.append(q.store.reshape(-1))
        head = tail = torch.zeros(C, dtype=torch.int32, device=dev)
    else:
        parts.append(q.directory.reshape(-1))
        head, tail = q.head, q.tail
    if lay.kind == "chunk":
        parts += [meta.bitmap.reshape(-1), meta.free_count,
                  meta.chunk_class]
    mem = torch.cat([p.to(torch.int32) for p in parts])
    if tele is None:
        tele = torch.zeros(lay.tele_words, dtype=torch.int32, device=dev)
    ctl = torch.cat([q.front, q.back, head, tail, ctx.pool.front,
                     ctx.pool.back, tele]).to(torch.int32)
    return Arena(mem=mem, ctl=ctl)


def unpack(lay: ArenaLayout, arena: Arena):
    """(q, ctx, meta) views into the arena words (writes go through)."""
    C = lay.num_classes
    mem, ctl = arena.mem, arena.ctl
    front = ctl[lay.off_front:lay.off_front + C]
    back = ctl[lay.off_back:lay.off_back + C]
    pool = queues.RingState(
        store=_take(lay, mem, "pool_store"),
        front=ctl[lay.off_pool_front:lay.off_pool_front + 1],
        back=ctl[lay.off_pool_back:lay.off_pool_back + 1])
    ctx = queues.AllocCtx(heap=heap_of(lay, arena), pool=pool)
    if lay.family == "ring":
        q = queues.RingState(store=_take(lay, mem, "queue_store"),
                             front=front, back=back)
    else:
        q = queues.VirtState(
            directory=_take(lay, mem, "directory"),
            head=ctl[lay.off_head:lay.off_head + C],
            tail=ctl[lay.off_tail:lay.off_tail + C],
            front=front, back=back)
    meta = None
    if lay.kind == "chunk":
        meta = ChunkMeta(bitmap=_take(lay, mem, "bitmap"),
                         free_count=_take(lay, mem, "free_count"),
                         chunk_class=_take(lay, mem, "chunk_class"))
    return q, ctx, meta


def blank(lay: ArenaLayout, device) -> Arena:
    """Arena words before the pool and queues are initialised: zeros,
    with NULL queue rings/directories and unbound chunks."""
    mem = torch.zeros(lay.mem_words, dtype=torch.int32, device=device)
    for name in ("queue_store", "directory", "chunk_class"):
        if lay.has(name):
            r = lay.region(name)
            mem[r.offset:r.end] = queues.NULL
    ctl = torch.zeros(lay.ctl_words, dtype=torch.int32, device=device)
    return Arena(mem=mem, ctl=ctl)
