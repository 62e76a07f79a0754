"""The port's CUDA kernel sources, compiled for the host and held to their
plain PyTorch versions on the CPU: sharded allocator transactions
(``sharded_alloc_txn``, ``sharded_free_txn``: buckets, the attempt grid,
homes near 2^31, past 31 shards, chunk runs and enqueues across shards,
every variant).

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

from repro_torch.core import HeapConfig, Ouroboros, shards
from repro_torch.core import transactions as T
from repro_torch.kernels import alloc_txn as AT
from repro_torch.kernels import defrag_txn as DT
from repro_torch.kernels.alloc_txn import (SHARD_STATS, TABLE_SMEM_LIMIT,
                                           descriptor)

from cuda_emu.emu import emu  # noqa: F401  (the harness fixture)
from cuda_emu.emu import (CHUNK_VARIANTS, OTHER_VARIANTS, SHARD_CFG, SPILL,
                          _free_stats, _p, _run_lanes, _stats)


# every allocator and wave kernel's launch count, in the harness's order
LAUNCHES = AT.LAUNCH_STATS + DT.LAUNCH_STATS


def _sharded_step(emu, o, st, mem, ctl, rng, live, n, hint, limit):
    """One alloc (homes from ``hint``: None hashes, an array pins) or
    free transaction through the plain replay (the facade on the CPU)
    and through the emulated kernel on copies of the words."""
    slay = o.layout
    d = descriptor(slay.shard)
    S, Mw, Cw = o.num_shards, slay.mem_words, slay.ctl_words
    if hint is not False:
        sizes = torch.from_numpy(rng.choice([256, 512, 1024, 4096, 8192],
                                            n, p=[.6, .15, .1, .1, .05])
                                 .astype(np.int32))
        mask = torch.from_numpy(rng.random(n) < 0.9)
        home = shards.home_shards(n, S, hint)
        st, want = o.alloc(st, sizes, mask, shard_hint=hint)
        got = torch.empty(n, dtype=torch.int32)
        emu.emu_sharded_alloc_txn(d, _p(mem), _p(ctl), S, Mw, Cw, _p(sizes),
                                  _p(mask), _p(home), n, o.walk, _p(got),
                                  limit)
        assert torch.equal(got, want)
        live += [(a, b) for a, b in zip(want.tolist(), sizes.tolist())
                 if a >= 0]
    else:
        k = min(len(live), int(rng.integers(1, n + 1)))
        pick = set(rng.choice(len(live), k, replace=False).tolist())
        drop = [x for i, x in enumerate(live) if i in pick]
        live[:] = [x for i, x in enumerate(live) if i not in pick]
        fo = np.full(n, -1, np.int32)
        fs = np.zeros(n, np.int32)
        fo[:k] = [a for a, _ in drop]
        fs[:k] = [b for _, b in drop]
        perm = rng.permutation(n)
        fo_t = torch.from_numpy(fo[perm].copy())
        fs_t = torch.from_numpy(fs[perm].copy())
        fm = fo_t >= 0
        st = o.free(st, fo_t, fs_t, fm)
        emu.emu_sharded_free_txn(d, _p(mem), _p(ctl), S, Mw, Cw, _p(fo_t),
                                 _p(fs_t), _p(fm), n, limit)
    return st


@pytest.mark.parametrize("walk,hinting,n,ops_,limit", [
    (None, "hashed", 16, 30, TABLE_SMEM_LIMIT),
    # every home on shard 0: exhausts it
    (None, "pinned-array", 16, 40, TABLE_SMEM_LIMIT),
    (1, "mixed", 32, 30, TABLE_SMEM_LIMIT),             # a bounded walk
    (None, "hashed", 16, 30, SPILL),
    (None, "pinned-array", 16, 40, SPILL),
], ids=("hashed", "exhausting-walk", "walk-1", "hashed-workspace",
        "exhausting-walk-workspace"))
def test_sharded_alloc_kernels_match_plain_replay(emu, walk, hinting, n,
                                                  ops_, limit):
    """Sharded alloc/free traces: the emulated ``sharded_alloc_txn`` /
    ``sharded_free_txn`` leave the plain replay's words and offsets
    after every transaction, with lanes served at walk attempts > 0 and
    (exhausting) steps that select no lane; with the lane tables in
    shared memory and (``*-workspace``, one table set per shard's block
    for the free) in the device workspace."""
    o = Ouroboros(HeapConfig(**SHARD_CFG), "vl_chunk", device="cpu",
                  num_shards=4, overflow_walk=walk)
    d = descriptor(o.layout.shard)
    spill = (emu.sharded_alloc_txn_workspace_bytes(d, n, limit) > 0,
             emu.free_txn_workspace_bytes(d, n, 4, limit) > 0)
    assert spill == ((True, True) if limit == SPILL else (False, False))
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(5)
    live = []
    for step in range(ops_):
        if live and step % 4 == 3:
            hint = False
        elif hinting == "hashed":
            hint = None
        elif hinting == "pinned-array":
            hint = np.zeros(n, np.int32)
        else:
            hint = rng.integers(-4, 8, n).astype(np.int32) if step % 2 \
                else None
        st = _sharded_step(emu, o, st, mem, ctl, rng, live, n, hint, limit)
        assert torch.equal(mem, st.mem), \
            f"mem differs after op {step} at " \
            f"{torch.nonzero(mem != st.mem)[:8].tolist()}"
        assert torch.equal(ctl, st.ctl), f"ctl differs after op {step}"
    lay = o.layout.shard
    bins = ctl[:, lay.off_t_walk:lay.off_t_walk + o.walk + 1].sum(0)
    assert int(bins[1:].sum()) > 0, bins


def _filled(cfg, S, full):
    """A fresh S-shard ``vl_chunk`` arena whose shards in ``full`` are
    filled with 256-B pages until a lane fails (homes pinned, no walk)."""
    fill = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=S,
                     overflow_walk=0)
    st = fill.init()
    sizes = torch.full((16,), 256, dtype=torch.int32)
    for s in full:
        while True:
            st, offs = fill.alloc(st, sizes, torch.ones(16, dtype=torch.bool),
                                  shard_hint=np.full(16, s, np.int32))
            if bool((offs < 0).any()):
                break
    return st


def _emu_sharded_alloc(emu, o, st, sizes, mask, home, limit):
    """One sharded alloc through the emulated kernel on copies of the
    words and through ``sharded_alloc_math``: offsets, mem and ctl equal.
    Returns (the plain ctl after it, the kernels' shard statistics, the
    launches that ran: {kernel: count}, those of none left out)."""
    slay = o.layout
    d = descriptor(slay.shard)
    S, n = o.num_shards, sizes.shape[0]
    mem, ctl = st.mem.clone(), st.ctl.clone()
    _stats(emu.emu_alloc_shard_stats, SHARD_STATS)
    _stats(emu.emu_launch_stats, LAUNCHES)
    got = torch.empty(n, dtype=torch.int32)
    emu.emu_sharded_alloc_txn(d, _p(mem), _p(ctl), S, slay.mem_words,
                              slay.ctl_words, _p(sizes), _p(mask), _p(home),
                              n, o.walk, _p(got), limit)
    stats = _stats(emu.emu_alloc_shard_stats, SHARD_STATS)
    ran = {k: v for k, v in _stats(emu.emu_launch_stats, LAUNCHES).items()
           if v}
    wm, wc = st.mem.clone(), st.ctl.clone()
    _, _, want = T.sharded_alloc_math(o.cfg, S, o.kind, o.family, wm, wc,
                                      sizes, mask, home, o.walk)
    assert torch.equal(got, want), \
        f"offsets differ at {torch.nonzero(got != want)[:8, 0].tolist()}"
    assert torch.equal(mem, wm), \
        f"mem differs at {torch.nonzero(mem != wm)[:8].tolist()}"
    assert torch.equal(ctl, wc), \
        f"ctl differs at {torch.nonzero(ctl != wc)[:8].tolist()}"
    return wc, stats, ran


def _sharded_launches(grid, attempts):
    """The launches a sharded alloc's kernels count: the warp-sized
    block, or the partition's two grids and ``attempts`` attempt
    launches."""
    if not grid:
        return {"sharded_alloc_txn": 1}
    return {"sharded_alloc_count": 1, "sharded_alloc_place": 1,
            "sharded_alloc_attempt": attempts}


def _walk_bins(o, before, after):
    lay = o.layout.shard
    sl = slice(lay.off_t_walk, lay.off_t_walk + o.walk + 1)
    return (after[:, sl].sum(0) - before[:, sl].sum(0)).tolist()


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("one-block", "attempt-grid-workspace"))
def test_sharded_alloc_serves_every_bucket_at_attempts_0_to_3(emu, limit):
    """Shards 0-2 full, 32 lanes homed on shards 0-3 in turn: bucket b
    is served at attempt 3 - b on shard 3, so every bucket and every
    attempt serves 8 lanes.  Words and offsets equal the plain math; the
    kernel ran 10 steps over 80 lanes (4 + 3 + 2 + 1 non-empty buckets,
    each step over its bucket's unserved lanes only), not 16 over all."""
    cfg = HeapConfig(**SHARD_CFG)
    o = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=4)
    d = descriptor(o.layout.shard)
    assert emu.sharded_alloc_txn_grid(d, 32, limit) == (limit == SPILL)
    st = _filled(cfg, 4, (0, 1, 2))
    home = torch.arange(32, dtype=torch.int32) % 4
    ctl, stats, ran = _emu_sharded_alloc(
        emu, o, st, torch.full((32,), 256, dtype=torch.int32),
        torch.ones(32, dtype=torch.bool), home, limit)
    assert _walk_bins(o, st.ctl, ctl) == [8, 8, 8, 8]
    assert stats == dict(transactions=1, steps=10, step_lanes=80,
                         rescans=0)
    assert ran == _sharded_launches(limit == SPILL, 4)


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("one-block", "attempt-grid-workspace"))
def test_sharded_alloc_skips_empty_buckets_past_an_exhausted_shard(emu,
                                                                   limit):
    """Homes on shards 0 and 2 only (buckets 1 and 3 empty), shard 2
    exhausted: bucket 0 is served at attempt 0, bucket 2 (15 selected
    lanes) fails there and is served at attempt 1 on shard 3.  Three
    steps run (46 lanes); the 13 others select no lane and are skipped
    from the bucket counts."""
    cfg = HeapConfig(**SHARD_CFG)
    o = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=4)
    st = _filled(cfg, 4, (2,))
    home = torch.tensor([0, 2] * 16, dtype=torch.int32)
    mask = torch.ones(32, dtype=torch.bool)
    mask[5] = False
    ctl, stats, _ = _emu_sharded_alloc(
        emu, o, st, torch.full((32,), 256, dtype=torch.int32), mask, home,
        limit)
    assert _walk_bins(o, st.ctl, ctl) == [16, 15, 0, 0]
    assert stats == dict(transactions=1, steps=3, step_lanes=46, rescans=0)


@pytest.mark.parametrize("hinting,n", [("pinned", 1100), ("hashed", 1100),
                                       ("hashed", 4500)])
def test_sharded_alloc_attempt_grid(emu, hinting, n):
    """Wide transactions take the partition's grids (1100 lanes: one
    tile; 4500: three, each placing its lanes after the earlier tiles')
    and the attempt launches of 4 blocks with each block's tables in its
    shared memory, the lists in the workspace; mixed sizes on the 4 x
    12-chunk arena exhaust shards, so steps serve some lanes and compact
    the rest (pinned: one bucket of 1100 lanes, more than a block's
    threads, compacted in two tiles)."""
    cfg = HeapConfig(**SHARD_CFG)
    o = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=4)
    d = descriptor(o.layout.shard)
    assert emu.sharded_alloc_txn_grid(d, n, TABLE_SMEM_LIMIT) == 1
    # the lists only: cnt, base (32 keys each), wraps, each partition
    # tile's key counts (2048 lanes a tile), idx, sz
    tiles = -(-n // 2048)
    assert emu.sharded_alloc_txn_workspace_bytes(d, n, TABLE_SMEM_LIMIT) \
        == 4 * (2 * 32 + 1 + 32 * tiles + 2 * n)
    rng = np.random.default_rng(21)
    sizes = torch.from_numpy(rng.choice([256, 512, 1024, 4096, 8192], n,
                                        p=[.6, .15, .1, .1, .05])
                             .astype(np.int32))
    home = (torch.zeros(n, dtype=torch.int32) if hinting == "pinned"
            else shards.home_shards(n, 4, None))
    st = o.init()
    ctl, stats, ran = _emu_sharded_alloc(emu, o, st, sizes,
                                         torch.ones(n, dtype=torch.bool),
                                         home, TABLE_SMEM_LIMIT)
    bins = _walk_bins(o, st.ctl, ctl)
    assert bins[0] > 0 and sum(bins) < n     # served some, failed some
    assert stats["transactions"] == 1 and stats["rescans"] == 0
    assert ran == _sharded_launches(True, 4)


INT_MAX = 2 ** 31 - 1


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("one-block", "attempt-grid-workspace"))
@pytest.mark.parametrize("top,rescans", [(INT_MAX, 1), (INT_MAX - 2, 0)],
                         ids=("wrapping", "at-the-edge"))
def test_sharded_alloc_homes_near_2_31(emu, top, rescans, limit):
    """3 shards, walk 2, shard 1 full.  A home of 2^31 - 1 wraps at
    attempt 1 as (home + a) % S does in int32: the lane visits shards 1,
    1, 2 (not 1, 2, 0), so the transaction takes per-step lists found by
    passes over all lanes.  A home of 2^31 - 3 reaches 2^31 - 1 at the
    last attempt without wrapping: bucket lists."""
    cfg = HeapConfig(**SHARD_CFG)
    o = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=3)
    assert o.walk == 2
    st = _filled(cfg, 3, (1,))
    home = torch.tensor([top, 0, 1, 2] * 6, dtype=torch.int32)
    _, stats, _ = _emu_sharded_alloc(
        emu, o, st, torch.full((24,), 256, dtype=torch.int32),
        torch.ones(24, dtype=torch.bool), home, limit)
    assert stats["rescans"] == rescans and stats["transactions"] == 1


@pytest.mark.parametrize("n,limit", [(24, TABLE_SMEM_LIMIT), (24, SPILL),
                                     (100, TABLE_SMEM_LIMIT)],
                         ids=("one-block", "attempt-workspace",
                              "100-lanes"))
@pytest.mark.parametrize("S", (31, 32, 33))
def test_sharded_alloc_past_31_shards(emu, S, n, limit):
    """More shards than the bucket lists' 31 (S buckets and the wrapping
    key in one 32-lane ballot): the transaction takes per-step lists,
    which rank one key, so any S is served.  6 chunks a shard, walk 2,
    shards 0 and 1 full, homes 0, 1, 2 and hashed ones in turn: lanes
    are served at attempts 0-2 (100 lanes overflow shard 2 and fail).  The warp-sized
    block, or one attempt launch of one block (no partition runs).  At
    31 shards the bucket lists still hold every key."""
    cfg = HeapConfig(total_bytes=S * 6 * 4096, chunk_bytes=4096,
                     min_page_bytes=256)
    o = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=S,
                  overflow_walk=2)
    d = descriptor(o.layout.shard)
    grid = bool(emu.sharded_alloc_txn_grid(d, n, limit))
    assert grid == (n > 32 or limit == SPILL)
    st = _filled(cfg, S, (0, 1))
    home = torch.arange(n, dtype=torch.int32) % 3
    home[3::4] = shards.home_shards(n, S, None)[3::4]
    ctl, stats, ran = _emu_sharded_alloc(
        emu, o, st, torch.full((n,), 256, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), home, limit)
    bins = _walk_bins(o, st.ctl, ctl)
    assert bins[1] > 0 and bins[2] > 0
    assert stats["transactions"] == 1 and stats["rescans"] == int(S > 31)
    assert ran == (_sharded_launches(grid, 3) if S <= 31
                   else {"sharded_alloc_attempt": 1} if grid
                   else {"sharded_alloc_txn": 1})


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("smem", "workspace"))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_sharded_chunk_runs_match_plain_replay(emu, variant, limit):
    """The sharded body: every lane homed on shard 0, more whole chunks
    than it holds, so runs happen on shard 0 and then on the shards the
    overflow walk reaches: offsets and words equal the plain replay's."""
    o = Ouroboros(HeapConfig(**SHARD_CFG), variant, device="cpu",
                  num_shards=4)
    slay = o.layout
    d = descriptor(slay.shard)
    S, Mw, Cw = o.num_shards, slay.mem_words, slay.ctl_words
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(6)
    for n in (300, 200):
        sizes, mask = _run_lanes(rng, n, 256, 512)
        hint = np.zeros(n, np.int32)
        home = shards.home_shards(n, S, hint)
        st, want = o.alloc(st, sizes, mask, shard_hint=hint)
        got = torch.empty(n, dtype=torch.int32)
        emu.emu_sharded_alloc_txn(d, _p(mem), _p(ctl), S, Mw, Cw, _p(sizes),
                                  _p(mask), _p(home), n, o.walk, _p(got),
                                  limit)
        assert torch.equal(got, want)
        assert torch.equal(mem, st.mem) and torch.equal(ctl, st.ctl)
    assert int((want // slay.shard_words >= 2).sum()) > 0


@pytest.mark.parametrize("limit", (TABLE_SMEM_LIMIT, SPILL),
                         ids=("smem", "workspace"))
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_sharded_chunk_free_enqueues_in_parallel(emu, variant, limit):
    """A sharded free of whole chunks' lanes spread over the 4 shards
    (permuted, a few masked off or unowned): each shard's block writes
    its revived chunks in parallel (one enqueue a shard, every revived
    chunk counted), and the words equal the plain replay's; in the
    workspace the lane passes run on the grid for all shards at once."""
    o = Ouroboros(HeapConfig(**SHARD_CFG), variant, device="cpu",
                  num_shards=4)
    slay = o.layout
    d = descriptor(slay.shard)
    S, Mw, Cw = o.num_shards, slay.mem_words, slay.ctl_words
    st = o.init()
    rng = np.random.default_rng(9)
    n = 4 * 6 * 16
    sizes = torch.full((n,), 256, dtype=torch.int32)
    st, offs = o.alloc(st, sizes, torch.ones(n, dtype=torch.bool))
    assert bool((offs >= 0).all())
    mem, ctl = st.mem.clone(), st.ctl.clone()
    perm = torch.from_numpy(rng.permutation(n))
    offs = offs[perm]
    offs[::37] = -1                       # unowned: no shard's lane
    mask = torch.from_numpy(rng.random(n) >= 0.05)
    shard_of = offs // slay.shard_words
    lay = slay.shard
    fc = st.mem[:, lay.region("free_count").offset:][:, :lay.cfg.num_chunks]
    hit = (offs >= 0) & mask
    key = torch.unique(shard_of[hit] * lay.cfg.num_chunks
                       + (offs[hit] % slay.shard_words)
                       // lay.cfg.words_per_chunk)
    want = int((fc.reshape(-1)[key] == 0).sum())
    assert want > 16
    st = o.free(st, offs, sizes, mask)
    _free_stats(emu)
    emu.emu_sharded_free_txn(d, _p(mem), _p(ctl), S, Mw, Cw, _p(offs),
                             _p(sizes), _p(mask), n, limit)
    assert torch.equal(mem, st.mem) and torch.equal(ctl, st.ctl)
    assert _free_stats(emu) == dict(parallel_enqueues=S,
                                    parallel_values=want,
                                    serial_enqueues=0, serial_values=0)


@pytest.mark.parametrize("variant,limit", [
    (v, TABLE_SMEM_LIMIT) for v in OTHER_VARIANTS] + [("va_page", SPILL)],
    ids=list(OTHER_VARIANTS) + ["va_page-workspace"])
def test_variant_sharded_kernels_match_plain_replay(emu, variant, limit):
    """Sharded traces of the other five variants (4 shards, homes hashed,
    pinned to shard 0 until they overflow, hinted per lane): the
    emulated ``sharded_alloc_txn``/``sharded_free_txn`` leave the plain
    replay's words and offsets, with lanes served at walk attempts > 0."""
    o = Ouroboros(HeapConfig(**SHARD_CFG), variant, device="cpu",
                  num_shards=4)
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(13)
    live = []
    n = 32
    for step in range(24):
        hint = False if live and step % 4 == 3 else (
            None, np.zeros(n, np.int32),
            rng.integers(-4, 8, n).astype(np.int32))[step % 3]
        st = _sharded_step(emu, o, st, mem, ctl, rng, live, n, hint, limit)
        assert torch.equal(mem, st.mem), \
            f"mem differs after op {step} at " \
            f"{torch.nonzero(mem != st.mem)[:8].tolist()}"
        assert torch.equal(ctl, st.ctl), f"ctl differs after op {step}"
    lay = o.layout.shard
    bins = ctl[:, lay.off_t_walk:lay.off_t_walk + o.walk + 1].sum(0)
    assert int(bins[1:].sum()) > 0, bins
