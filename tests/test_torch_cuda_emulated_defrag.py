"""The port's CUDA kernel sources, compiled for the host and held to their
plain PyTorch versions on the CPU: defragmentation waves
(``defrag_txn``, ``sharded_defrag_txn``: plans, dry pools, unbound
chunks, the rebuilds, ring and va waves).

``tests/cuda_emu`` emulates the device features the kernels use (a
std::thread per CUDA thread, block and warp barriers, host atomics), so
the kernel bodies of ``src/repro_torch/csrc/*.cu`` run here unchanged,
minus their host launchers; ``cuda_emu/emu.py`` builds that harness once
a module (the ``emu`` fixture).  This checks the kernels' logic on every
run; the card itself checks compilation for sm_90a and real concurrency
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Skips when no C++20
host compiler is available.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HeapConfig, Ouroboros, arena, defrag, shards
from repro_torch.kernels.alloc_txn import TABLE_SMEM_LIMIT, descriptor
from repro_torch.kernels.defrag_txn import REBUILD_STATS

from cuda_emu.emu import emu  # noqa: F401  (the harness fixture)
from cuda_emu.emu import SHARD_CFG, SPILL, _p, _stats


def _emu_sharded_wave(emu, o, st, src, dst, sizes, threads=256,
                      limit=TABLE_SMEM_LIMIT):
    slay = o.layout
    mem, ctl = st.mem.clone(), st.ctl.clone()
    d = descriptor(slay.shard)
    assert (emu.defrag_txn_workspace_bytes(d, o.num_shards, limit) > 0) \
        == (limit == SPILL)
    emu.emu_sharded_defrag_txn(d, _p(mem), _p(ctl),
                               o.num_shards, slay.mem_words, slay.ctl_words,
                               _p(src), _p(dst), _p(sizes), src.shape[0],
                               threads, limit)
    defrag.sharded_migrate_math(o.cfg, o.num_shards, o.kind, o.family,
                                st.mem, st.ctl, src, dst, sizes)
    assert torch.equal(mem, st.mem), \
        f"mem differs at {torch.nonzero(mem != st.mem)[:8].tolist()}"
    assert torch.equal(ctl, st.ctl), \
        f"ctl differs at {torch.nonzero(ctl != st.ctl)[:8].tolist()}"


@pytest.mark.parametrize("chunk_bytes,page,max_moves,rounds,limit", [
    (4096, 256, 128, 30, TABLE_SMEM_LIMIT),
    # 15 queue ids a segment; two shards left empty, so the rebalance
    # claims pool chunks of an idle receiver
    (64, 16, 4, 4, TABLE_SMEM_LIMIT),
    (4096, 256, 128, 30, SPILL),
], ids=("kv-geometry", "tiny-chunks", "kv-geometry-workspace"))
def test_sharded_defrag_kernel_matches_plain_math(emu, chunk_bytes, page,
                                                  max_moves, rounds, limit):
    """Churn with every lane homed on shard 0 (so it overflows), then a
    sharded compaction wave and a rebalance wave (cross-shard moves,
    claims of the receiver's pool chunks, every shard rebuilt): the
    emulated ``sharded_defrag_txn`` leaves ``sharded_migrate_math``'s
    words."""
    cfg = HeapConfig(total_bytes=4 * 12 * chunk_bytes,
                     chunk_bytes=chunk_bytes, min_page_bytes=page)
    o = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=4)
    rng = np.random.default_rng(3)
    n = 16
    sizes = torch.full((n,), page, dtype=torch.int32)
    st, live = o.init(), []
    for _ in range(rounds):
        st, offs = o.alloc(st, sizes, torch.from_numpy(rng.random(n) < 0.9),
                           shard_hint=np.zeros(n, np.int32))
        live += [x for x in offs.tolist() if x >= 0]
    drop = [x for i, x in enumerate(live) if i % 3]
    rng.shuffle(drop)
    for i in range(0, len(drop), n):
        fo = torch.full((n,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + n])] = torch.tensor(drop[i:i + n],
                                               dtype=torch.int32)
        st = o.free(st, fo, sizes, fo >= 0)
    plan = defrag.sharded_plan_math(o.cfg, 4, o.kind, o.family, st.mem,
                                    st.ctl, max_moves=max_moves)
    assert int((plan[0] >= 0).sum()) > 0
    _emu_sharded_wave(emu, o, st, *plan, limit=limit)
    plan = shards.rebalance_plan_math(o.cfg, 4, o.kind, o.family, st.mem,
                                      st.ctl, max_moves=max_moves)
    src_sh = plan[0][plan[0] >= 0] // o.layout.shard_words
    dst_sh = plan[1][plan[1] >= 0] // o.layout.shard_words
    assert src_sh.numel() > 0 and bool((src_sh != dst_sh).all())
    _emu_sharded_wave(emu, o, st, *plan, limit=limit)


def _churn(o, st, rng, n, page, until_full, keep_every=5, rounds=14):
    """The reference defrag test's churn: allocate (until the heap is
    exhausted, or for ``rounds`` transactions), then free all but every
    ``keep_every``-th grant in shuffled batches."""
    sizes = torch.full((n,), page, dtype=torch.int32)
    live, fails = [], 0
    for step in range(200):
        if (fails >= 2) if until_full else (step >= rounds):
            break
        st, offs = o.alloc(st, sizes, torch.from_numpy(rng.random(n) < 0.95))
        got = [int(x) for x in offs.tolist() if x >= 0]
        fails = fails + 1 if not got else 0
        live += got
    drop = [x for i, x in enumerate(live) if i % keep_every]
    rng.shuffle(drop)
    for i in range(0, len(drop), n):
        fo = torch.full((n,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + n])] = torch.tensor(drop[i:i + n],
                                               dtype=torch.int32)
        st = o.free(st, fo, sizes, fo >= 0)
    return st, live[::keep_every]


def _emu_wave(emu, o, st, src, dst, sizes, threads, limit=TABLE_SMEM_LIMIT):
    """The emulated kernel on copies of the arena against
    ``migrate_math`` on the arena itself (the per-chunk tables in the
    device workspace when ``limit`` is lowered)."""
    mem, ctl = st.mem.clone(), st.ctl.clone()
    d = descriptor(o.layout)
    assert (emu.defrag_txn_workspace_bytes(d, 1, limit) > 0) \
        == (limit == SPILL)
    emu.emu_defrag_txn(d, _p(mem), _p(ctl), _p(src),
                       _p(dst), _p(sizes), src.shape[0], threads, limit)
    defrag.migrate_math(o.cfg, o.kind, o.family, st.mem, st.ctl, src, dst,
                        sizes)
    assert torch.equal(mem, st.mem), \
        f"mem differs at {torch.nonzero(mem != st.mem)[:8, 0].tolist()}"
    assert torch.equal(ctl, st.ctl), \
        f"ctl differs at {torch.nonzero(ctl != st.ctl)[:8, 0].tolist()}"


@pytest.mark.parametrize("cfgkw,page,n,threads,limit", [
    (dict(total_bytes=1 << 15, chunk_bytes=1 << 11, min_page_bytes=64),
     64, 16, 1024, TABLE_SMEM_LIMIT),
    (dict(total_bytes=1 << 15, chunk_bytes=1 << 11, min_page_bytes=64),
     128, 16, 64, TABLE_SMEM_LIMIT),
    (dict(total_bytes=30 * 4096, chunk_bytes=4096, min_page_bytes=256),
     256, 16, 256, TABLE_SMEM_LIMIT),
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     16, 64, 128, TABLE_SMEM_LIMIT),
    (dict(total_bytes=30 * 4096, chunk_bytes=4096, min_page_bytes=256),
     256, 16, 256, SPILL),
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     16, 64, 128, SPILL),
], ids=("test-defrag-cfg", "class-1", "kv-geometry", "tiny-chunks",
        "kv-geometry-workspace", "tiny-chunks-workspace"))
def test_defrag_kernel_matches_plain_math(emu, cfgkw, page, n, threads,
                                          limit):
    """Churn until full, wave, churn again, wave: the kernel's words
    equal ``migrate_math``'s after every wave."""
    o = Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device="cpu")
    st = o.init()
    rng = np.random.default_rng(11)
    moved = 0
    for wave in range(2):
        st, _ = _churn(o, st, rng, n, page, until_full=(wave == 0))
        src, dst, sizes = defrag.plan_math(o.cfg, o.kind, o.family, st.mem,
                                           st.ctl)
        moved += int((src >= 0).sum())
        _emu_wave(emu, o, st, src, dst, sizes, threads, limit)
    assert moved > 0


def _strand(o, k, n=16):
    """Fill the heap with 16-B pages, then free one page in each of the
    first ``k`` chunks: many partially full chunks, no free one."""
    st, live = o.init(), []
    sizes = torch.full((n,), 16, dtype=torch.int32)
    while True:
        st, offs = o.alloc(st, sizes, torch.ones(n, dtype=torch.bool))
        got = [x for x in offs.tolist() if x >= 0]
        if not got:
            break
        live += got
    first = {}
    for x in live:
        first.setdefault(x // o.cfg.words_per_chunk, x)
    drop = list(first.values())[:k]
    for i in range(0, len(drop), n):
        fo = torch.full((n,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + n])] = torch.tensor(drop[i:i + n],
                                               dtype=torch.int32)
        st = o.free(st, fo, sizes, fo >= 0)
    return st


@pytest.mark.parametrize("total_bytes,k,max_moves", [
    (1 << 12, 40, 1), (1 << 12, 20, 2), (1 << 13, 40, 4)])
def test_defrag_kernel_grows_segments_from_a_dry_pool(emu, total_bytes, k,
                                                      max_moves):
    """64-B chunks hold 15 queue ids per segment: a truncated wave over
    dozens of partially full chunks grows class queues by whole
    segments, and the rebuilt pool (only the old segment chunks) runs
    dry, so pops past its inventory hand out NULL segments whose writes
    wrap into the last chunk — all as the reference does."""
    o = Ouroboros(HeapConfig(total_bytes=total_bytes, chunk_bytes=64,
                             min_page_bytes=16), "vl_chunk", device="cpu")
    st = _strand(o, k)
    src, dst, sizes = defrag.plan_math(o.cfg, o.kind, o.family, st.mem,
                                       st.ctl, max_moves=max_moves)
    _emu_wave(emu, o, st, src, dst, sizes, 128)
    q, ctx, _ = arena.unpack(o.layout, st)
    assert int(ctx.pool.front[0]) > int(ctx.pool.back[0])     # ran dry
    assert int(q.back[0]) > o.cfg.slots_per_segment("vl")     # grew


def test_defrag_kernel_claims_unbound_destination_chunks(emu):
    """A hand-built plan whose destinations lie in pool chunks (the
    claim path), with a lane repeated chunk and an over-large lane."""
    cfg = HeapConfig(total_bytes=1 << 15, chunk_bytes=1 << 11,
                     min_page_bytes=64)
    o = Ouroboros(cfg, "vl_chunk", device="cpu")
    st, kept = _churn(o, o.init(), np.random.default_rng(9), 16, 64, False)
    _, ctx, meta = arena.unpack(o.layout, st)
    pool = defrag._pool_members(cfg, ctx.pool) & (meta.chunk_class < 0)
    a, b = torch.nonzero(pool)[-2:, 0].tolist()
    wpc = cfg.words_per_chunk
    src = torch.tensor(kept[:4] + [-1, kept[4]], dtype=torch.int32)
    dst = torch.tensor([a * wpc, a * wpc + 32, b * wpc + 64, a * wpc + 16,
                        b * wpc, b * wpc + 128], dtype=torch.int32)
    sizes = torch.tensor([64, 64, 64, 64, 64, 1 << 13], dtype=torch.int32)
    _emu_wave(emu, o, st, src, dst, sizes, 64)
    assert int(meta.chunk_class[a]) == 0 and int(meta.chunk_class[b]) == 0


def test_defrag_kernel_last_lane_claims_an_unbound_chunk(emu):
    """Lanes of two size classes land in one unbound chunk: the claim
    binds it to the class of the last such lane, as the reference's
    scatter resolves repeated indices (chunk a: class 1 then class 0;
    chunk b: class 0 then class 1)."""
    cfg = HeapConfig(total_bytes=1 << 15, chunk_bytes=1 << 11,
                     min_page_bytes=64)
    o = Ouroboros(cfg, "vl_chunk", device="cpu")
    st, kept = _churn(o, o.init(), np.random.default_rng(9), 16, 64, False)
    _, ctx, meta = arena.unpack(o.layout, st)
    pool = defrag._pool_members(cfg, ctx.pool) & (meta.chunk_class < 0)
    a, b = torch.nonzero(pool)[-2:, 0].tolist()
    wpc = cfg.words_per_chunk
    src = torch.tensor(kept[:4], dtype=torch.int32)
    dst = torch.tensor([a * wpc, a * wpc + 64, b * wpc + 16, b * wpc + 128],
                       dtype=torch.int32)
    sizes = torch.tensor([128, 64, 64, 128], dtype=torch.int32)
    _emu_wave(emu, o, st, src, dst, sizes, 64)
    assert int(meta.chunk_class[a]) == 0 and int(meta.chunk_class[b]) == 1


# (variant, total bytes, stranded chunks, max moves) of a wave on 64-B
# chunks whose rebuild pops exactly the rebuilt pool (gap 0: the values
# are written in parallel) or one more (gap 1: a NULL segment, written
# in order), as the plain wave's pool counters show
WAVE_EDGES = {"vl-gap-0": ("vl_chunk", 1 << 12, 2, 1, 0),
              "vl-gap-1": ("vl_chunk", 1 << 12, 16, 1, 1),
              "va-gap-0": ("va_chunk", 1 << 12, 2, 1, 0),
              "va-gap-1": ("va_chunk", 1 << 12, 18, 1, 1)}


@pytest.mark.parametrize("case", tuple(WAVE_EDGES))
def test_wave_rebuild_writes_in_parallel_while_the_pool_holds_its_pops(
        emu, case):
    """The rebuild's serial edge: a virtualized queue's values go in
    parallel exactly when the rebuilt pool holds every pop the rebuild
    takes, by the wave kernel's own counts, and the words equal
    ``migrate_math``'s either way."""
    variant, total, k, moves, gap = WAVE_EDGES[case]
    o = Ouroboros(HeapConfig(total_bytes=total, chunk_bytes=64,
                             min_page_bytes=16), variant, device="cpu")
    st = _strand(o, k)
    plan = defrag.plan_math(o.cfg, o.kind, o.family, st.mem, st.ctl,
                            max_moves=moves)
    _stats(emu.emu_defrag_rebuild_stats, REBUILD_STATS)
    _emu_wave(emu, o, st, *plan, 128)
    got = _stats(emu.emu_defrag_rebuild_stats, REBUILD_STATS)
    _, ctx, _ = arena.unpack(o.layout, st)
    assert int(ctx.pool.front[0]) - int(ctx.pool.back[0]) == gap
    assert got["parallel_rebuilds"] == (gap == 0)
    assert got["serial_rebuilds"] == (gap > 0)


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("shared", "workspace"))
def test_wave_rebuild_paths_single_and_sharded(emu, limit):
    """A truncated wave on the churned 30-chunk KV arena and a truncated
    sharded compaction wave on 4 x 12 chunks (two of three pages freed)
    rebuild from pools that hold their pops: every rebuild (one an arena)
    writes its live chunks' values in parallel; the dry pool of 64-B
    chunks (40 stranded chunks, one move) takes the lane-order path."""
    o = Ouroboros(HeapConfig(total_bytes=30 * 4096, chunk_bytes=4096,
                             min_page_bytes=256), "vl_chunk", device="cpu")
    st, _ = _churn(o, o.init(), np.random.default_rng(11), 16, 256, True)
    _stats(emu.emu_defrag_rebuild_stats, REBUILD_STATS)
    _emu_wave(emu, o, st, *defrag.plan_math(o.cfg, o.kind, o.family,
                                            st.mem, st.ctl, max_moves=4),
              256, limit)
    so = Ouroboros(HeapConfig(**SHARD_CFG), "vl_chunk", device="cpu",
                   num_shards=4)
    ss, live = so.init(), []
    sizes = torch.full((16,), 256, dtype=torch.int32)
    for _ in range(12):
        ss, offs = so.alloc(ss, sizes, torch.ones(16, dtype=torch.bool),
                            shard_hint=np.zeros(16, np.int32))
        live += [x for x in offs.tolist() if x >= 0]
    drop = [x for i, x in enumerate(live) if i % 3]
    for i in range(0, len(drop), 16):
        fo = torch.full((16,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + 16])] = torch.tensor(drop[i:i + 16],
                                               dtype=torch.int32)
        ss = so.free(ss, fo, sizes, fo >= 0)
    _emu_sharded_wave(emu, so, ss, *defrag.sharded_plan_math(
        so.cfg, 4, so.kind, so.family, ss.mem, ss.ctl, max_moves=8),
        limit=limit)
    got = _stats(emu.emu_defrag_rebuild_stats, REBUILD_STATS)
    assert got["parallel_rebuilds"] == 1 + 4 and got["serial_rebuilds"] == 0
    assert got["parallel_values"] > 0
    d = Ouroboros(HeapConfig(total_bytes=1 << 12, chunk_bytes=64,
                             min_page_bytes=16), "vl_chunk", device="cpu")
    sd = _strand(d, 40)
    _emu_wave(emu, d, sd, *defrag.plan_math(d.cfg, d.kind, d.family, sd.mem,
                                            sd.ctl, max_moves=1), 128)
    got = _stats(emu.emu_defrag_rebuild_stats, REBUILD_STATS)
    assert got["serial_rebuilds"] == 1 and got["parallel_rebuilds"] == 0


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("smem", "workspace"))
@pytest.mark.parametrize("chunk_bytes,page", [(4096, 256), (64, 16)],
                         ids=("kv-geometry", "tiny-chunks"))
@pytest.mark.parametrize("variant", ("chunk", "va_chunk"))
def test_ring_and_va_waves_match_plain_math(emu, variant, chunk_bytes, page,
                                            limit):
    """The ring and va rebuilds: churn, then a wave (``defrag_txn``),
    more churn and a second wave; then the same arena geometry over 4
    shards with every lane homed on shard 0, a sharded compaction wave
    and a rebalance wave onto the idle shards (``sharded_defrag_txn``)."""
    cfg = HeapConfig(total_bytes=30 * chunk_bytes, chunk_bytes=chunk_bytes,
                     min_page_bytes=page)
    o = Ouroboros(cfg, variant, device="cpu")
    st = o.init()
    rng = np.random.default_rng(17)
    moved = 0
    for wave in range(2):
        st, _ = _churn(o, st, rng, 16, page, until_full=(wave == 0))
        src, dst, sizes = defrag.plan_math(o.cfg, o.kind, o.family, st.mem,
                                           st.ctl)
        moved += int((src >= 0).sum())
        _emu_wave(emu, o, st, src, dst, sizes, 128, limit)
    assert moved > 0
    so = Ouroboros(HeapConfig(total_bytes=4 * 12 * chunk_bytes,
                              chunk_bytes=chunk_bytes, min_page_bytes=page),
                   variant, device="cpu", num_shards=4)
    st, live = so.init(), []
    sizes = torch.full((16,), page, dtype=torch.int32)
    for _ in range(6):   # fills shard 0 (and 1 with tiny chunks) alone
        st, offs = so.alloc(st, sizes, torch.from_numpy(rng.random(16) < .9),
                            shard_hint=np.zeros(16, np.int32))
        live += [x for x in offs.tolist() if x >= 0]
    drop = [x for i, x in enumerate(live) if i % 3]
    for i in range(0, len(drop), 16):
        fo = torch.full((16,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + 16])] = torch.tensor(drop[i:i + 16],
                                                dtype=torch.int32)
        st = so.free(st, fo, sizes, fo >= 0)
    for plan in (defrag.sharded_plan_math, shards.rebalance_plan_math):
        src, dst, sz = plan(so.cfg, 4, so.kind, so.family, st.mem, st.ctl,
                            max_moves=32)
        assert int((src >= 0).sum()) > 0
        _emu_sharded_wave(emu, so, st, src, dst, sz, limit=limit)
