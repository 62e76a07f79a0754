"""The port's CUDA kernel sources, compiled for the host and held to their
plain PyTorch versions on the CPU: single-arena allocator transactions
(``alloc_txn``, ``free_txn``: every variant, chunk runs, dequeue runs,
the free's enqueues).

``tests/cuda_emu`` emulates the device features the kernels use (a
std::thread per CUDA thread, block and warp barriers, host atomics), so
the kernel bodies of ``src/repro_torch/csrc/*.cu`` run here unchanged,
minus their host launchers; ``cuda_emu/emu.py`` builds that harness once
a module (the ``emu`` fixture).  This checks the kernels' logic on every
run; the card itself checks compilation for sm_90a and real concurrency
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Skips when no C++20
host compiler is available.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import VARIANTS, HeapConfig, Ouroboros, arena
from repro_torch.kernels.alloc_txn import (CHAIN_STATS, TABLE_SMEM_LIMIT,
                                           descriptor)

from cuda_emu.emu import emu  # noqa: F401  (the harness fixture)
from cuda_emu.emu import (CHUNK_VARIANTS, OTHER_VARIANTS, SPILL, _free_stats,
                          _p, _run_lanes)


@pytest.mark.parametrize("cfgkw,menu,n,ops_,bias,limit", [
    (dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16),
     [16, 24, 100, 256, 1000, 2048, 8192], 16, 20, 0.6, TABLE_SMEM_LIMIT),
    (dict(total_bytes=1 << 16, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64, 128], 16, 24, 0.6, TABLE_SMEM_LIMIT),
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64], 64, 40, 0.8, TABLE_SMEM_LIMIT),
    (dict(total_bytes=24 * 4096, chunk_bytes=4096, min_page_bytes=256),
     [256, 512, 4096, 8192], 128, 24, 0.6, TABLE_SMEM_LIMIT),
    (dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16),
     [16, 24, 100, 256, 1000, 2048, 8192], 16, 20, 0.6, SPILL),
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64], 64, 40, 0.8, SPILL),
    (dict(total_bytes=24 * 4096, chunk_bytes=4096, min_page_bytes=256),
     [256, 512, 4096, 8192], 128, 24, 0.6, SPILL),
], ids=("mixed", "segment-churn", "exhausting", "kv-geometry",
        "mixed-workspace", "exhausting-workspace", "kv-geometry-workspace"))
def test_alloc_kernels_match_plain_math(emu, cfgkw, menu, n, ops_, bias,
                                        limit):
    """Alloc/free traces: the emulated ``alloc_txn``/``free_txn`` leave
    the plain math's words and offsets after every transaction, with the
    lane tables in shared memory and (``*-workspace``) in the device
    workspace."""
    cfg = HeapConfig(**cfgkw)
    o = Ouroboros(cfg, "vl_chunk", device="cpu")
    d = descriptor(o.layout)
    spill = (emu.alloc_txn_workspace_bytes(d, n, limit) > 0,
             emu.free_txn_workspace_bytes(d, n, 1, limit) > 0)
    assert spill == ((True, True) if limit == SPILL else (False, False))
    _emu_trace(emu, o, o.init(), menu, n, ops_, bias, limit)


def _emu_trace(emu, o, st, menu, n, ops_, bias, limit, seed=7):
    """A seeded alloc/free trace through the facade on the CPU (the plain
    math) and through the emulated ``alloc_txn``/``free_txn`` on copies
    of the words: offsets, ``mem`` and ``ctl`` equal after every
    transaction.  Returns the failed lanes."""
    d = descriptor(o.layout)
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(seed)
    live, failed = [], 0
    for step in range(ops_):
        if not live or rng.random() < bias:
            sizes = torch.from_numpy(rng.choice(menu, n).astype(np.int32))
            mask = torch.from_numpy(rng.random(n) < 0.85)
            st, want = o.alloc(st, sizes, mask)
            got = torch.empty(n, dtype=torch.int32)
            emu.emu_alloc_txn(d, _p(mem), _p(ctl), _p(sizes), _p(mask), n,
                              _p(got), limit)
            assert torch.equal(got, want), step
            failed += int(((want < 0) & mask).sum())
            live += [(int(a), int(b)) for a, b in
                     zip(want.tolist(), sizes.tolist()) if a >= 0]
        else:
            k = min(len(live), int(rng.integers(1, n + 1)))
            pick = set(rng.choice(len(live), k, replace=False).tolist())
            drop = [x for i, x in enumerate(live) if i in pick]
            live = [x for i, x in enumerate(live) if i not in pick]
            fo = np.full(n, -1, np.int32)
            fs = np.zeros(n, np.int32)
            fo[:k] = [a for a, _ in drop]
            fs[:k] = [b for _, b in drop]
            perm = rng.permutation(n)
            fo_t = torch.from_numpy(fo[perm].copy())
            fs_t = torch.from_numpy(fs[perm].copy())
            fm = fo_t >= 0
            st = o.free(st, fo_t, fs_t, fm)
            emu.emu_free_txn(d, _p(mem), _p(ctl), _p(fo_t), _p(fs_t),
                             _p(fm), n, limit)
        assert torch.equal(mem, st.mem), \
            f"mem differs after op {step} at " \
            f"{torch.nonzero(mem != st.mem)[:8, 0].tolist()}"
        assert torch.equal(ctl, st.ctl), \
            f"ctl differs after op {step} at " \
            f"{torch.nonzero(ctl != st.ctl)[:8, 0].tolist()}"
    return failed


def test_single_arena_alloc_kernel_bins_served_lanes_at_walk_bin_0(emu):
    """The walk-bin argument of the shared transaction body: a single
    arena's served lanes all land in walk bin 0, as before."""
    o = Ouroboros(HeapConfig(total_bytes=1 << 16, chunk_bytes=1 << 11,
                             min_page_bytes=16), "vl_chunk", device="cpu")
    lay = o.layout
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    sizes = torch.tensor([16, 64, 2048, 8192] * 8, dtype=torch.int32)
    mask = torch.ones(32, dtype=torch.bool)
    for _ in range(3):
        st, want = o.alloc(st, sizes, mask)
        got = torch.empty(32, dtype=torch.int32)
        emu.emu_alloc_txn(descriptor(lay), _p(mem), _p(ctl), _p(sizes),
                          _p(mask), 32, _p(got), TABLE_SMEM_LIMIT)
        assert torch.equal(got, want) and torch.equal(ctl, st.ctl)
    walk = ctl[lay.off_t_walk:lay.off_t_walk + arena.TELE_WALK_BINS]
    served = int(ctl[lay.off_t_alloc:lay.off_t_alloc
                     + lay.num_classes].sum())
    assert served > 0 and walk.tolist() == [served] + [0] * 7
VARIANT_CASES = {
    # 32 chunks of 2 KiB, 8 classes; 64 lanes: page kinds' values written
    # in parallel
    "mixed": (dict(total_bytes=1 << 16, chunk_bytes=1 << 11,
                   min_page_bytes=16),
              [16, 24, 100, 256, 1000, 2048, 8192], 64, 16, 0.6,
              TABLE_SMEM_LIMIT),
    # 64-B chunks: va segments of 16 slots, vl of 15
    "segment-churn": (dict(total_bytes=1 << 16, chunk_bytes=64,
                           min_page_bytes=16),
                      [16, 32, 64, 128], 64, 24, 0.6, TABLE_SMEM_LIMIT),
    "exhausting": (dict(total_bytes=1 << 12, chunk_bytes=64,
                        min_page_bytes=16),
                   [16, 32, 64], 64, 40, 0.8, TABLE_SMEM_LIMIT),
    "workspace": (dict(total_bytes=1 << 16, chunk_bytes=64,
                       min_page_bytes=16),
                  [16, 32, 64, 128], 64, 24, 0.6, SPILL),
}


@pytest.mark.parametrize("case", tuple(VARIANT_CASES))
@pytest.mark.parametrize("variant", OTHER_VARIANTS)
def test_variant_alloc_kernels_match_plain_math(emu, variant, case):
    """Alloc/free traces of the other five variants: the emulated
    ``alloc_txn``/``free_txn`` leave the plain math's words and offsets
    after every transaction (``exhausting``: failed lanes and segment
    pops past the pool; ``workspace``: the lane tables, the page-vl chain
    table included, in the device workspace)."""
    cfgkw, menu, n, ops_, bias, limit = VARIANT_CASES[case]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    d = descriptor(o.layout)
    ws = (emu.alloc_txn_workspace_bytes(d, n, limit) > 0,
          emu.free_txn_workspace_bytes(d, n, 1, limit) > 0)
    # a page ring or va alloc needs no lane table
    assert ws == ((o.kind == "chunk" or o.family == "vl", True)
                  if limit == SPILL else (False, False))
    failed = _emu_trace(emu, o, o.init(), menu, n, ops_, bias, limit)
    assert failed > 0 or case != "exhausting"
# heap, the lanes' main size and a second size: ppc = chunk / size
RUN_CFGS = {
    "ppc-16": (dict(total_bytes=48 * 4096, chunk_bytes=4096,
                    min_page_bytes=256), 256, 512),
    "ppc-32": (dict(total_bytes=24 * 8192, chunk_bytes=8192,
                    min_page_bytes=256), 256, 1024),
    "ppc-1": (dict(total_bytes=96 * 4096, chunk_bytes=4096,
                   min_page_bytes=256), 4096, 2048),
    # 64-B chunks: va segments of 16 queue slots, vl of 15, so runs
    # cross segments
    "ppc-4-short-segments": (dict(total_bytes=256 * 64, chunk_bytes=64,
                                  min_page_bytes=16), 16, 32),
}


def _emu_alloc(emu, o, st, mem, ctl, sizes, mask, limit):
    """One alloc through the plain math and through the emulated
    ``alloc_txn`` on the copies ``mem``/``ctl``: offsets and words
    equal.  Returns (state, offsets)."""
    st, want = o.alloc(st, sizes, mask)
    got = torch.empty(sizes.shape[0], dtype=torch.int32)
    emu.emu_alloc_txn(descriptor(o.layout), _p(mem), _p(ctl), _p(sizes),
                      _p(mask), sizes.shape[0], _p(got), limit)
    assert torch.equal(got, want)
    assert torch.equal(mem, st.mem), \
        f"mem differs at {torch.nonzero(mem != st.mem)[:8, 0].tolist()}"
    assert torch.equal(ctl, st.ctl), \
        f"ctl differs at {torch.nonzero(ctl != st.ctl)[:8, 0].tolist()}"
    return st, want


def _emu_free(emu, o, st, mem, ctl, offs, sizes, limit):
    mask = offs >= 0
    st = o.free(st, offs, sizes, mask)
    emu.emu_free_txn(descriptor(o.layout), _p(mem), _p(ctl), _p(offs),
                     _p(sizes), _p(mask), offs.shape[0], limit)
    assert torch.equal(mem, st.mem) and torch.equal(ctl, st.ctl)
    return st


def _pool(o, st):
    """(slots tensor view, front, back) of the arena's pool ring."""
    lay = o.layout
    r = lay.region("pool_store")
    return (st.mem[r.offset:r.offset + o.cfg.num_chunks],
            int(st.ctl[lay.off_pool_front]), int(st.ctl[lay.off_pool_back]))


def _queue_count(o, st, c):
    lay = o.layout
    return int(st.ctl[lay.off_back + c]) - int(st.ctl[lay.off_front + c])


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("smem", "workspace"))
@pytest.mark.parametrize("cfg", tuple(RUN_CFGS))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chunk_run_after_draining_the_class_queue(emu, variant, cfg, limit):
    """A grant that first drains a class queue of partially used chunks
    (thread 0's serial steps) and then runs over many fresh pool chunks
    (the block's whole-chunk run), then a partial last chunk: offsets
    and words equal the plain math's after every transaction, for ppc
    16, 32 and 1, the lane tables in shared memory and in the
    workspace."""
    cfgkw, size, other = RUN_CFGS[cfg]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    c = int(np.log2(size // cfgkw["min_page_bytes"]))
    ppc = cfgkw["chunk_bytes"] // size
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(ppc)
    live = []
    for n in (3 * ppc + ppc // 2 + 1, 2 * ppc + 1):
        sizes, mask = _run_lanes(rng, n, size, other)
        st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes, mask, limit)
        live += [(a, b) for a, b in zip(offs.tolist(), sizes.tolist())
                 if a >= 0]
    drop = live[::3]          # revives full chunks into the class queues
    fo = torch.tensor([a for a, _ in drop], dtype=torch.int32)
    fs = torch.tensor([b for _, b in drop], dtype=torch.int32)
    st = _emu_free(emu, o, st, mem, ctl, fo, fs, limit)
    assert _queue_count(o, st, c) > 0
    _, pf0, _ = _pool(o, st)
    n = min(256, (o.cfg.num_chunks - 8) * ppc)
    sizes, mask = _run_lanes(rng, n, size, other)
    st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes, mask, limit)
    _, pf1, _ = _pool(o, st)
    assert pf1 - pf0 >= 4 and bool((offs[mask] >= 0).all())


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("smem", "workspace"))
@pytest.mark.parametrize("cfg", tuple(RUN_CFGS))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_dequeue_runs_match_plain_math(emu, variant, cfg, limit):
    """Class queues of revived chunks taken by dequeue runs: whole chunks
    freed in two batches (the later batch of lower ids, so the queue's
    ids fall once: a run ends there, thread 0 dequeues the chunk that
    ended it and the next run goes on), partly used chunks among them,
    then grants longer than the queue (the pool run follows) and shorter
    (a partial last chunk, re-enqueued): offsets and words equal the
    plain math's after every transaction."""
    cfgkw, size, other = RUN_CFGS[cfg]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    c = int(np.log2(size // cfgkw["min_page_bytes"]))
    ppc = cfgkw["chunk_bytes"] // size
    wpc = o.cfg.words_per_chunk
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(3 * ppc)
    n = min(768, (o.cfg.num_chunks - 8) * ppc)   # 16-88 chunks
    sizes = torch.full((n,), size, dtype=torch.int32)
    st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes,
                          torch.ones(n, dtype=torch.bool), limit)
    chunks = sorted({x // wpc for x in offs.tolist()})
    half = len(chunks) // 2
    for batch in (chunks[half:], chunks[:half]):   # high ids, then low
        keep = set(batch)
        fo = torch.tensor([x for x in offs.tolist() if x // wpc in keep
                           and (x // wpc != batch[0] or x % 3)],
                          dtype=torch.int32)
        fo = fo[torch.from_numpy(rng.permutation(fo.shape[0]))]
        st = _emu_free(emu, o, st, mem, ctl, fo, torch.full_like(fo, size),
                       limit)
    assert _queue_count(o, st, c) >= len(chunks) - 1
    for lanes in (n // 3 + 1, n):
        sizes, mask = _run_lanes(rng, lanes, size, other, p_other=0.1)
        st, got = _emu_alloc(emu, o, st, mem, ctl, sizes, mask, limit)
        assert bool((got[mask] >= 0).any())


def _queue_word(o, st, c, v):
    """The arena word holding class ``c``'s queue entry at position
    ``v`` (the ring slot, or the heap word through the va directory or
    the vl chain from the head)."""
    lay, cfg = o.layout, o.cfg
    mem, wpc = st.mem, cfg.words_per_chunk
    spc = cfg.slots_per_segment(lay.family)
    if lay.family == "ring":
        cap = lay.queue_capacity
        return lay.region("queue_store").offset + c * cap + v % cap
    front = int(st.ctl[lay.off_front + c])
    if lay.family == "va":
        seg = int(mem[lay.region("directory").offset + c * lay.max_segs
                      + (v // spc) % lay.max_segs])
        return seg * wpc + v % spc
    seg = int(st.ctl[lay.off_head + c])
    for _ in range(v // spc - front // spc):
        seg = int(mem[seg * wpc])
    return seg * wpc + 1 + v % spc


@pytest.mark.parametrize("defect", ("repeat", "free-count-off"))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_dequeue_run_stops_at_a_bad_entry(emu, variant, defect):
    """A class queue that holds one chunk twice in a row (``repeat``), or
    a chunk whose free count disagrees with its free bits
    (``free-count-off``): a dequeue run ends before it (ids must rise,
    and the count must match the bits), thread 0 dequeues it serially
    (a repeat is full by then: it takes nothing and is not re-enqueued)
    and the next run goes on."""
    cfgkw, size, _ = RUN_CFGS["ppc-16"]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    wpc = o.cfg.words_per_chunk
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    n = 24 * 16
    sizes = torch.full((n,), size, dtype=torch.int32)
    st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes,
                          torch.ones(n, dtype=torch.bool), TABLE_SMEM_LIMIT)
    st = _emu_free(emu, o, st, mem, ctl, offs, sizes, TABLE_SMEM_LIMIT)
    front = int(st.ctl[o.layout.off_front])
    assert _queue_count(o, st, 0) >= 24
    if defect == "repeat":
        st.mem[_queue_word(o, st, 0, front + 4)] = \
            st.mem[_queue_word(o, st, 0, front + 3)]
    else:
        chunk = int(st.mem[_queue_word(o, st, 0, front + 4)])
        st.mem[o.layout.region("free_count").offset + chunk] = 9
    mem.copy_(st.mem)
    _, got = _emu_alloc(emu, o, st, mem, ctl, sizes,
                        torch.ones(n, dtype=torch.bool), TABLE_SMEM_LIMIT)
    if defect == "repeat":
        assert bool((got >= 0).all())
        assert len({x // wpc for x in got.tolist()}) == n // 16


def _rotate_pool(o, st, front_slot):
    """The same pool (ids in the same order) moved round its ring so
    that its front sits at slot ``front_slot``."""
    slots, pf, pb = _pool(o, st)
    nc = o.cfg.num_chunks
    ids = [int(slots[(pf + i) % nc]) for i in range(pb - pf)]
    shift = (front_slot - pf) % nc
    for i, x in enumerate(ids):
        slots[(pf + shift + i) % nc] = x
    lay = o.layout
    st.ctl[lay.off_pool_front] = pf + shift
    st.ctl[lay.off_pool_back] = pb + shift
    return st


@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chunk_run_wraps_the_pool_ring(emu, variant):
    """The pool's front 3 slots before the end of its ring: the run's
    chunk k is slot (pool_front + k) mod num_chunks, across the wrap."""
    cfgkw, size, other = RUN_CFGS["ppc-16"]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    st = _rotate_pool(o, o.init(), o.cfg.num_chunks - 3)
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(1)
    sizes, mask = _run_lanes(rng, 200, size, other)
    st, _ = _emu_alloc(emu, o, st, mem, ctl, sizes, mask, TABLE_SMEM_LIMIT)
    _, pf, _ = _pool(o, st)
    assert pf > o.cfg.num_chunks + 3


@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chunk_run_exhausts_the_pool(emu, variant):
    """A run longer than the pool: it stops at the pool's last chunk,
    the class's other lanes fail, and the next transaction finds the
    pool empty at once."""
    o = Ouroboros(HeapConfig(total_bytes=12 * 4096, chunk_bytes=4096,
                             min_page_bytes=256), variant, device="cpu")
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(2)
    failed = 0
    for _ in range(2):
        sizes, mask = _run_lanes(rng, 256, 256, 1024)
        st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes, mask,
                              TABLE_SMEM_LIMIT)
        failed += int((mask & (offs < 0)).sum())
        _, pf, pb = _pool(o, st)
        assert pf == pb
    assert failed > 256


@pytest.mark.parametrize("bad", ("duplicate", "negative", "past-the-end",
                                 "duplicate-and-negative"))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chunk_run_with_repeated_or_out_of_range_pool_ids(emu, variant, bad):
    """Pool slots inside a whole-chunk run hold a repeated id (the block
    runs it: the repeat rewrites identical words, as the serial steps'
    reset does) or an id outside [0, num_chunks) (which reads the free
    count of the last chunk, plain indexing clamps, so that class goes
    on serially).  The last chunk is first bound to the 512-B class with
    pages to spare: an out-of-range id then takes its free bits as
    grants outside the heap (negative ones fail their lanes) and
    re-enters the class queue.
    Offsets and words (telemetry included) equal the plain math's."""
    cfgkw, size, other = RUN_CFGS["ppc-16"]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    st = o.init()
    slots, pf, pb = _pool(o, st)
    nc = o.cfg.num_chunks
    last = [i for i in range(pf, pb) if int(slots[i % nc]) == nc - 1][0]
    slots[last % nc], slots[pf % nc] = slots[pf % nc].clone(), nc - 1
    mem, ctl = st.mem.clone(), st.ctl.clone()
    st, _ = _emu_alloc(emu, o, st, mem, ctl,
                       torch.full((5,), 512, dtype=torch.int32),
                       torch.ones(5, dtype=torch.bool), TABLE_SMEM_LIMIT)
    slots, pf, _ = _pool(o, st)
    if "duplicate" in bad:
        slots[(pf + 2) % nc] = slots[(pf + 1) % nc]
    if "negative" in bad:
        slots[(pf + 5) % nc] = -1
    if bad == "past-the-end":
        slots[(pf + 4) % nc] = nc + 5
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(4)
    sizes, mask = _run_lanes(rng, 192, size, other)
    _, offs = _emu_alloc(emu, o, st, mem, ctl, sizes, mask, TABLE_SMEM_LIMIT)
    # the out-of-range id's steps grant offsets outside the heap
    outside = (offs[mask] < 0) | (offs[mask] >= o.cfg.total_words)
    assert bool(outside.any()) == (bad != "duplicate")


def _chain_stats(emu):
    """The emulated alloc kernels' chain statistics since the last call
    (read and cleared), by ``CHAIN_STATS`` name."""
    buf = (ctypes.c_ulonglong * len(CHAIN_STATS))()
    assert emu.emu_alloc_chain_stats(buf, 1) == len(CHAIN_STATS)
    return dict(zip(CHAIN_STATS, (int(v) for v in buf)))


# what one class chain of 256-B lanes on the 48-chunk ppc-16 heap takes
# (the rest of the statistics 0)
CHAIN_CASES = {
    # 5 whole chunks' lanes and 3: one run, then a partial pool chunk
    "whole-run": dict(serial_steps=1, whole_runs=1, whole_chunks=5),
    # 24 chunks freed whole, in ascending order, taken again: one try
    "dequeue-run": dict(dequeue_tries=1, dequeue_chunks=24),
    # queue entry 4's free count disagrees with its bits: a short try,
    # that entry dequeued serially, a try over the other 19, and a
    # partial pool chunk for the last 7 lanes
    "bad-entry-4": dict(serial_steps=2, dequeue_tries=2, dequeue_chunks=23,
                        dequeue_short=1),
    # the same at the queue's front: the first try takes nothing
    "bad-entry-0": dict(serial_steps=2, dequeue_tries=2, dequeue_chunks=23,
                        dequeue_short=1, dequeue_empty=1),
}


@pytest.mark.parametrize("case", tuple(CHAIN_CASES) + ("out-of-range",))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chain_stats_count_what_the_chain_took(emu, variant, case):
    """The kernel's own count of what an alloc's chunk chain took (runs,
    their chunks, serial steps, short and empty dequeue tries, a class
    left serial by a pool id outside the heap) equals what the plain
    math's chain does on these inputs; offsets and words as the plain
    math's."""
    cfgkw, size, _ = RUN_CFGS["ppc-16"]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    st = o.init()
    if case == "out-of-range":
        slots, pf, _ = _pool(o, st)
        slots[(pf + 2) % o.cfg.num_chunks] = -1
    mem, ctl = st.mem.clone(), st.ctl.clone()
    n = 5 * 16 + 3 if case in ("whole-run", "out-of-range") else 24 * 16
    sizes = torch.full((n,), size, dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool)
    if case.startswith(("dequeue", "bad")):
        st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes, mask,
                              TABLE_SMEM_LIMIT)
        perm = torch.from_numpy(np.random.default_rng(5).permutation(n))
        st = _emu_free(emu, o, st, mem, ctl, offs[perm], sizes,
                       TABLE_SMEM_LIMIT)
        assert _queue_count(o, st, 0) == 24
        if case.startswith("bad"):
            front = int(st.ctl[o.layout.off_front])
            chunk = int(st.mem[_queue_word(o, st, 0,
                                           front + int(case[-1]))])
            st.mem[o.layout.region("free_count").offset + chunk] = 9
            mem.copy_(st.mem)
    _chain_stats(emu)
    _emu_alloc(emu, o, st, mem, ctl, sizes, mask, TABLE_SMEM_LIMIT)
    got = _chain_stats(emu)
    if case == "out-of-range":
        assert got["serial_classes"] == 1 and got["whole_runs"] == 0
        assert got["serial_steps"] >= 6 and got["dequeue_tries"] == 0
        return
    want = dict.fromkeys(CHAIN_STATS, 0)
    want.update(chains=1, **CHAIN_CASES[case])
    assert got == want


@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_alloc_on_an_exhausted_arena_changes_only_its_failed_counts(
        emu, variant):
    """An alloc that no class can serve (each class with lanes has an
    empty queue and the pool is empty) skips the grants: its words and
    offsets equal the plain math's (only the failed counts move), and the
    kernel counts each class's chain, as the chain that ends before its
    first step would, and nothing else."""
    cfgkw, size, _ = RUN_CFGS["ppc-16"]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    fill = torch.full((64,), size, dtype=torch.int32)
    while True:
        st, offs = _emu_alloc(emu, o, st, mem, ctl, fill,
                              torch.ones(64, dtype=torch.bool),
                              TABLE_SMEM_LIMIT)
        if bool((offs < 0).any()):
            break
    sizes = torch.tensor([size, 2 * size] * 8, dtype=torch.int32)
    _chain_stats(emu)
    st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes,
                          torch.ones(16, dtype=torch.bool), TABLE_SMEM_LIMIT)
    assert bool((offs < 0).all())
    want = dict.fromkeys(CHAIN_STATS, 0)
    want["chains"] = 2
    assert _chain_stats(emu) == want


def _revived(o, st, offs):
    """The chunks a free of ``offs`` revives: full now, touched by it."""
    fc = st.mem[o.layout.region("free_count").offset:][:o.cfg.num_chunks]
    touched = torch.unique(offs[offs >= 0] // o.cfg.words_per_chunk)
    return int((fc[touched.long()] == 0).sum())


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("smem", "workspace"))
@pytest.mark.parametrize("cfg", ("ppc-16", "ppc-4-short-segments"))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chunk_free_enqueues_revived_chunks_in_parallel(emu, variant, cfg,
                                                        limit):
    """A retirement of whole chunks' lanes (ascending, then permuted, so
    that runs of lanes share a chunk or none do), plus a few lanes of a
    second class: the revived chunks cannot share a queue word, so the
    block writes them in parallel (the kernel's own count says so, for
    every revived chunk), and the words equal the plain math's; with
    4-page chunks the enqueue grows va and vl queues by several
    segments."""
    cfgkw, size, other = RUN_CFGS[cfg]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    ppc = cfgkw["chunk_bytes"] // size
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(ppc)
    for order in ("ascending", "permuted"):
        n = 24 * ppc
        sizes, mask = _run_lanes(rng, n, size, other, p_off=0.0)
        st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes, mask, limit)
        assert bool((offs >= 0).all())
        if order == "permuted":
            perm = torch.from_numpy(rng.permutation(n))
            offs, sizes = offs[perm], sizes[perm]
        want = _revived(o, st, offs)
        assert want > 16
        _free_stats(emu)
        st = _emu_free(emu, o, st, mem, ctl, offs, sizes, limit)
        assert _free_stats(emu) == dict(
            parallel_enqueues=1, parallel_values=want, serial_enqueues=0,
            serial_values=0), order


def _tail_segment(o, st, c):
    """The chunk that holds class ``c``'s next queue slot (vl: the tail;
    va: the directory's segment of ``back``)."""
    lay = o.layout
    if lay.family == "vl":
        return int(st.ctl[lay.off_tail + c])
    spc = o.cfg.slots_per_segment("va")
    back = int(st.ctl[lay.off_back + c])
    return int(st.mem[lay.region("directory").offset + c * lay.max_segs
                      + (back // spc) % lay.max_segs])


# each edge where two enqueued values could share a word, and the
# variants it applies to; a chunk kind never revives more chunks than a
# ring of chunk ids holds (its capacity is the chunk count), so the ring
# edge is a page ring's
FREE_EDGES = {
    "class-outside": CHUNK_VARIANTS,
    "pool-repeats-segment": ("va_chunk", "vl_chunk"),
    "back-past-2^31": CHUNK_VARIANTS,
    "ring-over-capacity": ("page",),
}


@pytest.mark.parametrize("variant,edge", [
    (v, e) for e, vs in FREE_EDGES.items() for v in vs])
def test_free_enqueue_takes_lane_order_at_each_edge(emu, variant, edge):
    """Each way two enqueued values can share a word (a revived chunk
    whose class lies outside [0, C); a grown segment repeating the tail
    chunk, as pops from an exhausted pool do; a class's back counter
    crossing 2^31; a page ring class freed past its capacity) sends the
    enqueue to thread 0's lane-order loop (the kernel's own count says
    so), and the words equal the plain math's, the reference's
    last-write-wins scatter included."""
    cfgkw, size, _ = RUN_CFGS["ppc-4-short-segments"]
    o = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu")
    lay = o.layout
    st = o.init()
    if edge == "back-past-2^31":
        st = _past_2_31(st, lay)
    mem, ctl = st.mem.clone(), st.ctl.clone()
    if edge == "ring-over-capacity":
        # more freed pages of class 0 than its ring holds: offsets of
        # class-0 pages, repeated
        n = lay.queue_capacity + 24
        sizes = torch.full((n,), size, dtype=torch.int32)
        st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes[:64],
                              torch.ones(64, dtype=torch.bool),
                              TABLE_SMEM_LIMIT)
        offs = offs[torch.arange(n) % 64]
        values = n
    else:
        n = 24 * 4
        sizes = torch.full((n,), size, dtype=torch.int32)
        st, offs = _emu_alloc(emu, o, st, mem, ctl, sizes,
                              torch.ones(n, dtype=torch.bool),
                              TABLE_SMEM_LIMIT)
        values = _revived(o, st, offs)
        if edge == "class-outside":
            chunk = int(offs[5]) // o.cfg.words_per_chunk
            st.mem[lay.region("chunk_class").offset + chunk] = \
                lay.num_classes
        elif edge == "pool-repeats-segment":
            slots, pf, _ = _pool(o, st)
            c = int(np.log2(size // cfgkw["min_page_bytes"]))
            for j in range(4):
                slots[(pf + j) % o.cfg.num_chunks] = _tail_segment(o, st, c)
        mem.copy_(st.mem)
    _free_stats(emu)
    _emu_free(emu, o, st, mem, ctl, offs, sizes, TABLE_SMEM_LIMIT)
    assert _free_stats(emu) == dict(parallel_enqueues=0, parallel_values=0,
                                    serial_enqueues=1, serial_values=values)


def _past_2_31(st, lay, past=3):
    """Every class queue's counters, and the pool's, moved so that the
    back lies ``past`` slots below 2^31 (counts kept)."""
    C = lay.num_classes
    ctl = st.ctl.to(torch.int64)
    for off in [lay.off_back + c for c in range(C)] + [lay.off_pool_back]:
        front = lay.off_pool_front if off == lay.off_pool_back \
            else off - C
        dlt = 2 ** 31 - past - int(ctl[off])
        ctl[off] += dlt
        ctl[front] += dlt
    st.ctl.copy_(ctl.to(torch.int32))
    return st


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_kernels_at_counters_past_2_31(emu, variant):
    """Counters carried over 2^31 inside the traces: the kernels wrap
    ``front + rank`` and the counters at 32 bits, as the plain math does
    (a page ring's slots then collide, and thread 0 writes them)."""
    o = Ouroboros(HeapConfig(total_bytes=1 << 16, chunk_bytes=1 << 11,
                             min_page_bytes=16), variant, device="cpu")
    st = _past_2_31(o.init(), o.layout)
    _emu_trace(emu, o, st, [16, 16, 32, 64], 64, 10, 0.7, TABLE_SMEM_LIMIT)
    assert int(st.ctl[:o.layout.core_ctl_words].min()) < 0
