"""Wrappers of the CUDA allocator transaction kernels
(``csrc/alloc_txn.cu``): one launch per whole alloc or free transaction
on an arena, or a sharded arena, of any of the six variants, that lies
on the card.  Also the
piecewise allocator's steps (``csrc/ring_txn.cu``,
``csrc/bitmap_txn.cu``): ``ring_txn_pop``, ``ring_txn_push`` and
``chunk_txn_claim``, one launch each.

Each wrapper checks devices, dtypes, shapes and contiguity, allocates
its output with ``torch.empty``, launches on the current stream, and
raises if the launch reports an error.  A transaction takes any lane
count: lane tables that do not fit in a block's shared memory go to a
device workspace, also from ``torch.empty`` (:func:`workspace`).
``mem`` and ``ctl`` are updated in place.  The plain versions are
``core/transactions.alloc_math`` / ``free_math`` /
``sharded_alloc_math`` / ``sharded_free_math``; ``kernels/ops`` picks
between them by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import arena
from repro_torch.core.heap import _log2i
from repro_torch.core.shards import shard_config
from repro_torch.kernels import build, ops

_FIELDS = ("total_words", "num_chunks", "wpc", "bw", "num_classes",
           "min_page_log2", "chunk_bytes", "min_page_words", "max_ppc",
           "spc", "pool_off", "bitmap_off", "free_off", "class_off",
           "ctl_words", "core_ctl_words", "wrap_capacity", "walk_bins",
           "kind", "family", "queue_off", "queue_cap", "max_segs")
KINDS = {"page": 0, "chunk": 1}          # csrc/arena_dev.cuh KIND_*
FAMILIES = {"ring": 0, "va": 1, "vl": 2}  # FAM_*
MAX_CTL = 256
MAX_CLASSES = 32
# dynamic shared memory for lane tables: a block may use 232,448 bytes
# on the H100, of which the kernels' static shared structs take under
# 8 KB (csrc/arena_dev.cuh kStaticSmemBytes)
TABLE_SMEM_LIMIT = 232448 - 8192


class ArenaDesc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _FIELDS]


@functools.lru_cache(maxsize=None)
def descriptor(lay: arena.ArenaLayout) -> ArenaDesc:
    """The kernel's view of an arena layout (any of the six variants),
    built once per layout.  Regions a kind lacks (the chunk tables of a
    page kind) have offset −1."""
    cfg = lay.cfg
    if lay.ctl_words > MAX_CTL or lay.num_classes > MAX_CLASSES:
        raise ValueError(f"arena with {lay.num_classes} classes / "
                         f"{lay.ctl_words} ctl words exceeds the kernel's "
                         f"{MAX_CLASSES} / {MAX_CTL}")

    def off(name):
        return lay.region(name).offset if lay.has(name) else -1

    return ArenaDesc(
        total_words=cfg.total_words, num_chunks=cfg.num_chunks,
        wpc=cfg.words_per_chunk, bw=cfg.bitmap_words_per_chunk,
        num_classes=lay.num_classes,
        min_page_log2=_log2i(cfg.min_page_bytes),
        chunk_bytes=cfg.chunk_bytes, min_page_words=cfg.page_words(0),
        max_ppc=cfg.max_pages_per_chunk,
        spc=cfg.slots_per_segment(lay.family),
        pool_off=off("pool_store"), bitmap_off=off("bitmap"),
        free_off=off("free_count"), class_off=off("chunk_class"),
        ctl_words=lay.ctl_words, core_ctl_words=lay.core_ctl_words,
        wrap_capacity=lay.wrap_capacity, walk_bins=arena.TELE_WALK_BINS,
        kind=KINDS[lay.kind], family=FAMILIES[lay.family],
        queue_off=off("queue_store" if lay.family == "ring"
                      else "directory"),
        queue_cap=lay.queue_capacity, max_segs=lay.max_segs)


def _lib():
    lib = build.load("alloc_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        Z = ctypes.c_size_t
        lib.alloc_txn_launch.argtypes = [ArenaDesc, P, P, P, P, I, P, P, P]
        lib.alloc_txn_launch.restype = I
        lib.free_txn_launch.argtypes = [ArenaDesc, P, P, P, P, P, I, P, P]
        lib.free_txn_launch.restype = I
        lib.sharded_alloc_txn_launch.argtypes = [ArenaDesc, P, P, I, I, I,
                                                 P, P, P, I, I, P, P, Z, P]
        lib.sharded_alloc_txn_launch.restype = I
        lib.sharded_free_txn_launch.argtypes = [ArenaDesc, P, P, I, I, I,
                                                P, P, P, I, P, P]
        lib.sharded_free_txn_launch.restype = I
        for name in ("alloc_txn", "sharded_alloc_txn"):
            fn = getattr(lib, f"{name}_workspace_bytes")
            fn.argtypes = [ArenaDesc, I, Z]
            fn.restype = Z
        lib.free_txn_workspace_bytes.argtypes = [ArenaDesc, I, I, Z]
        lib.free_txn_workspace_bytes.restype = Z
        lib.sharded_alloc_txn_grid.argtypes = [ArenaDesc, I, Z]
        lib.sharded_alloc_txn_grid.restype = I
        for fn in (lib.alloc_txn_chain_stats, lib.free_txn_enqueue_stats,
                   lib.alloc_txn_shard_stats, lib.alloc_txn_launch_stats):
            fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), I]
            fn.restype = I
        lib._typed = True
    return lib


# csrc/alloc_txn.cu's ChainStat, in order
CHAIN_STATS = ("chains", "serial_steps", "whole_runs", "whole_chunks",
               "dequeue_tries", "dequeue_chunks", "dequeue_short",
               "dequeue_empty", "serial_classes")


def read_stats(fn, names, reset: bool) -> dict:
    """A kernel library's device counters ``fn`` reads, by ``names``,
    after waiting for the card; ``reset`` clears them after the read."""
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * len(names))()
    err = fn(buf, int(reset))
    if err:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    return dict(zip(names, (int(v) for v in buf)))


def chain_stats(reset: bool = False) -> dict:
    """What the chunk chains of every ``alloc_txn`` and
    ``sharded_alloc_txn`` launch since the last reset took, summed on the
    card by the kernels themselves: class chains, thread 0's serial
    steps, whole-chunk runs and their chunks, dequeue runs tried, their
    chunks, and the tries that took fewer than 16 or no chunks, and
    chains left serial by a pool id outside the heap.  Waits for the
    card; ``reset`` clears the counts after reading them."""
    return read_stats(_lib().alloc_txn_chain_stats, CHAIN_STATS, reset)


# csrc/alloc_txn.cu's ShardStat, in order
SHARD_STATS = ("transactions", "steps", "step_lanes", "rescans")


def shard_stats(reset: bool = False) -> dict:
    """What every ``sharded_alloc_txn`` since the last reset did, counted
    on the card by the kernels themselves: transactions, the (attempt,
    shard) steps that ran the transaction body (a step whose bucket holds
    no unserved lane is skipped) and the lanes they took, and the
    transactions that found each step's lanes by a pass over all lanes (a
    home within the walk of 2^31 wraps).  Waits for the card; ``reset``
    clears the counts after reading them."""
    return read_stats(_lib().alloc_txn_shard_stats, SHARD_STATS, reset)


# csrc/alloc_txn.cu's FreeStat, in order
FREE_STATS = ("parallel_enqueues", "parallel_values", "serial_enqueues",
              "serial_values")


def enqueue_stats(reset: bool = False) -> dict:
    """What the bulk enqueues of every ``free_txn`` and
    ``sharded_free_txn`` launch (one enqueue a block) since the last
    reset did, counted on the card by the kernels themselves: enqueues
    whose values the block wrote in parallel and the values they wrote,
    enqueues thread 0 wrote in lane order (two values could share a
    word) and their values.  Waits for the card; ``reset`` clears the
    counts after reading them."""
    return read_stats(_lib().free_txn_enqueue_stats, FREE_STATS, reset)


# csrc/alloc_txn.cu's TxnLaunch, in order: each kernel's symbol without
# its ``_kernel`` suffix
LAUNCH_STATS = ("alloc_txn", "free_txn", "free_lanes", "sharded_alloc_txn",
                "sharded_alloc_count", "sharded_alloc_place",
                "sharded_alloc_attempt", "sharded_free_txn")


def launch_stats(reset: bool = False) -> dict:
    """Each transaction kernel's launches since the last reset, counted
    on the card by the launches themselves (a call may launch several
    kernels: a sharded alloc's partition and attempts, a wide free's
    lane passes).  Waits for the card; ``reset`` clears the counts after
    reading them."""
    return read_stats(_lib().alloc_txn_launch_stats, LAUNCH_STATS, reset)


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(cfg, kind, family, mem, ctl, num_shards=None):
    """Layout, descriptor and device of a transaction's arena; with
    ``num_shards`` the arena is sharded (``cfg`` the global config) and
    the layout and descriptor are one shard's."""
    lead = ()
    if num_shards is not None:
        cfg = shard_config(cfg, num_shards)
        lead = (num_shards,)
    lay = arena.layout(cfg, kind, family)
    dev = mem.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA transaction kernel needs an arena on "
                         f"the card, got {dev}")
    _check("mem", mem, torch.int32, lead + (lay.mem_words,), dev)
    _check("ctl", ctl, torch.int32, lead + (lay.ctl_words,), dev)
    return lay, descriptor(lay), dev


def workspace(nbytes: int, dev):
    """The device workspace of a launch whose lane tables need
    ``nbytes`` beyond shared memory (``*_workspace_bytes``), or None
    when they fit there.  The caching allocator keeps it for the launch:
    it is freed on the launch's stream, after the launch in order."""
    if not nbytes:
        return None
    return torch.empty(-(-nbytes // 4), dtype=torch.int32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def arena_alloc_txn(cfg, kind, family, mem, ctl, sizes_bytes, mask):
    """One alloc transaction in one launch; returns offsets (n,) int32."""
    n = sizes_bytes.shape[0]
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl)
    _check("sizes_bytes", sizes_bytes, torch.int32, (n,), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    lib = _lib()
    ws = workspace(lib.alloc_txn_workspace_bytes(desc, n, TABLE_SMEM_LIMIT),
                   dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.alloc_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                               sizes_bytes.data_ptr(), mask.data_ptr(), n,
                               out.data_ptr(), _ptr(ws), _stream(dev))
    if err:
        raise RuntimeError(f"alloc_txn launch failed: CUDA error {err}")
    ops.count("alloc_txn")
    return out


def arena_free_txn(cfg, kind, family, mem, ctl, offsets_words, sizes_bytes,
                   mask):
    """One free transaction in one launch (``mem``/``ctl`` in place)."""
    n = offsets_words.shape[0]
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl)
    _check("offsets_words", offsets_words, torch.int32, (n,), dev)
    _check("sizes_bytes", sizes_bytes, torch.int32, (n,), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    lib = _lib()
    ws = workspace(lib.free_txn_workspace_bytes(desc, n, 1, TABLE_SMEM_LIMIT),
                   dev)
    err = lib.free_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                              offsets_words.data_ptr(),
                              sizes_bytes.data_ptr(), mask.data_ptr(), n,
                              _ptr(ws), _stream(dev))
    if err:
        raise RuntimeError(f"free_txn launch failed: CUDA error {err}")
    ops.count("free_txn")


def sharded_arena_alloc_txn(cfg, num_shards, kind, family, mem, ctl,
                            sizes_bytes, mask, home, walk):
    """One sharded alloc transaction (the (walk+1, S) overflow-walk
    schedule), for any number of shards; returns GLOBAL offsets (n,)
    int32.  It launches one warp-sized block that runs every step (at
    most 32 lanes whose tables fit in shared memory), or the partition's
    ``sharded_alloc_count_kernel`` and ``sharded_alloc_place_kernel``
    over the card and then ``walk + 1`` launches of
    ``sharded_alloc_attempt_kernel`` (an attempt each, a block per
    shard); past 31 shards, one attempt launch of one block.
    :func:`launch_stats` counts what ran."""
    n = sizes_bytes.shape[0]
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl, num_shards)
    _check("sizes_bytes", sizes_bytes, torch.int32, (n,), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    _check("home", home, torch.int32, (n,), dev)
    if not isinstance(walk, int) or not 0 <= walk < num_shards:
        raise ValueError(f"walk must be an int in [0, {num_shards}), got "
                         f"{walk!r}")
    lib = _lib()
    ws = workspace(lib.sharded_alloc_txn_workspace_bytes(desc, n,
                                                         TABLE_SMEM_LIMIT),
                   dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.sharded_alloc_txn_launch(
        desc, mem.data_ptr(), ctl.data_ptr(), num_shards, lay.mem_words,
        lay.ctl_words, sizes_bytes.data_ptr(), mask.data_ptr(),
        home.data_ptr(), n, walk, out.data_ptr(), _ptr(ws), TABLE_SMEM_LIMIT,
        _stream(dev))
    if err:
        raise RuntimeError(f"sharded_alloc_txn launch failed: CUDA error "
                           f"{err}")
    ops.count("sharded_alloc_txn")
    return out


def sharded_arena_free_txn(cfg, num_shards, kind, family, mem, ctl,
                           offsets_words, sizes_bytes, mask):
    """One sharded free transaction in one launch of S blocks, one per
    shard (``mem``/``ctl`` in place)."""
    n = offsets_words.shape[0]
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl, num_shards)
    _check("offsets_words", offsets_words, torch.int32, (n,), dev)
    _check("sizes_bytes", sizes_bytes, torch.int32, (n,), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    lib = _lib()
    ws = workspace(lib.free_txn_workspace_bytes(desc, n, num_shards,
                                                TABLE_SMEM_LIMIT), dev)
    err = lib.sharded_free_txn_launch(
        desc, mem.data_ptr(), ctl.data_ptr(), num_shards, lay.mem_words,
        lay.ctl_words, offsets_words.data_ptr(), sizes_bytes.data_ptr(),
        mask.data_ptr(), n, _ptr(ws), _stream(dev))
    if err:
        raise RuntimeError(f"sharded_free_txn launch failed: CUDA error "
                           f"{err}")
    ops.count("sharded_free_txn")


# ---------------------------------------------------------------------------
# the piecewise allocator's steps (csrc/ring_txn.cu, csrc/bitmap_txn.cu)
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1


def ring_lib():
    """The loaded ``ring_txn.cu`` library, its launchers typed."""
    lib = build.load("ring_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ring_txn_pop_launch.argtypes = [P, P, P, P, P, I, I, I, I, P, P,
                                            P]
        lib.ring_txn_push_launch.argtypes = [P, P, P, P, P, I, I, I, P, P]
        lib.ring_window_launch.argtypes = [P, P, P, I, I, I, P, P]
        for fn in (lib.ring_txn_pop_launch, lib.ring_txn_push_launch,
                   lib.ring_window_launch):
            fn.restype = I
        lib.ring_txn_launch_stats.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), I]
        lib.ring_txn_launch_stats.restype = I
        lib._typed = True
    return lib


# csrc/ring_txn.cu's RingLaunch, in order: each pop and push kernel's
# symbol without its ``_kernel`` suffix (its path: one warp, one block
# ranking every class, one block per class)
RING_LAUNCH_STATS = ("ring_txn_pop_warp", "ring_txn_pop_block",
                     "ring_txn_pop_class", "ring_txn_push_warp",
                     "ring_txn_push_block", "ring_txn_push_class")


def ring_launch_stats(reset: bool = False) -> dict:
    """Each ring pop and push kernel's launches since the last reset, by
    path, counted on the card by the launches themselves: a warp for 32
    lanes or fewer, a block ranking every class above that, a block per
    class past 32 classes.  Waits for the card; ``reset`` clears the
    counts after reading them."""
    return read_stats(ring_lib().ring_txn_launch_stats, RING_LAUNCH_STATS,
                      reset)


def bitmap_lib():
    """The loaded ``bitmap_txn.cu`` library, its launchers typed."""
    lib = build.load("bitmap_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.chunk_txn_claim_launch.argtypes = [P, I, I, I, P, P, P, P]
        lib.bitmap_select_launch.argtypes = [P, I, I, P, P]
        lib.chunk_txn_claim_launch.restype = I
        lib.bitmap_select_launch.restype = I
        lib._typed = True
    return lib


def on_card(name, t):
    """The device of a piecewise step's first tensor, which must lie on
    the card."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA {name} kernel needs tensors on the "
                         f"card, got {t.device}")
    return t.device


def launched(name, err):
    """Raise if a launch reported an error, else count it."""
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    ops.count(name)


def _ring_lanes(name, store, counters, cls, valid, extra=()):
    C, cap = store.shape
    dev = on_card(name, store)
    _check("store", store, torch.int32, (C, cap), dev)
    for nm, t in counters:
        _check(nm, t, torch.int32, (C,), dev)
    n = cls.shape[0]
    _check("cls", cls, torch.int32, (n,), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    for nm, t in extra:
        _check(nm, t, torch.int32, (n,), dev)
    return C, cap, n, dev


def ring_txn_pop(store, front, back, cls, valid, *, limit: bool):
    """Bulk pop of the class rings (``ref.ring_txn_pop_ref``) in one
    launch: one warp for 32 lanes or fewer, else one block that ranks
    every class at once (a block per class past 32 classes; see
    :func:`ring_launch_stats`).  Returns ``(vals (n,), new front
    (C,))``.  A transaction of 0 lanes launches nothing."""
    C, cap, n, dev = _ring_lanes("ring_txn_pop", store,
                                 (("front", front), ("back", back)), cls,
                                 valid)
    vals = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return vals, front.clone()
    new_front = torch.empty(C, dtype=torch.int32, device=dev)
    err = ring_lib().ring_txn_pop_launch(
        store.data_ptr(), front.data_ptr(), back.data_ptr(), cls.data_ptr(),
        valid.data_ptr(), n, C, cap, int(bool(limit)), vals.data_ptr(),
        new_front.data_ptr(), _stream(dev))
    launched("ring_txn_pop", err)
    return vals, new_front


def ring_txn_push(store, back, cls, vals, valid):
    """Bulk push (``ref.ring_txn_push_ref``), in place on ``store``, in
    one launch on the pop's paths.  Returns ``(store, new back (C,))``.
    A transaction of 0 lanes launches nothing."""
    C, cap, n, dev = _ring_lanes("ring_txn_push", store, (("back", back),),
                                 cls, valid, (("vals", vals),))
    if n == 0:
        return store, back.clone()
    new_back = torch.empty(C, dtype=torch.int32, device=dev)
    err = ring_lib().ring_txn_push_launch(
        store.data_ptr(), back.data_ptr(), cls.data_ptr(), vals.data_ptr(),
        valid.data_ptr(), n, C, cap, new_back.data_ptr(), _stream(dev))
    launched("ring_txn_push", err)
    return store, new_back


def chunk_txn_claim(row, take: int, *, ppc: int):
    """Claim of one chunk's first ``take`` free pages below ``ppc``
    (``ref.chunk_txn_claim_ref``) in one launch of one block.  Returns
    ``(page_idx (32 bw,), new row (bw,), claimed count (1,))``; every
    call launches, ``take`` 0 included."""
    dev = on_card("chunk_txn_claim", row)
    bw = row.shape[0]
    _check("row", row, torch.int32, (bw,), dev)
    take = max(-1, min(int(take), INT32_MAX))
    page_idx = torch.empty(32 * bw, dtype=torch.int32, device=dev)
    new_row = torch.empty(bw, dtype=torch.int32, device=dev)
    nsel = torch.empty(1, dtype=torch.int32, device=dev)
    err = bitmap_lib().chunk_txn_claim_launch(
        row.data_ptr(), bw, take, int(ppc), page_idx.data_ptr(),
        new_row.data_ptr(), nsel.data_ptr(), _stream(dev))
    launched("chunk_txn_claim", err)
    return page_idx, new_row, nsel
