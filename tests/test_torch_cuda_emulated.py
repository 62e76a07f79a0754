"""The port's CUDA kernel sources, compiled for the host and held to
their plain PyTorch versions on the CPU.

``tests/cuda_emu`` emulates the device features the kernels use (a
std::thread per CUDA thread, block and warp barriers, host atomics), so
the kernel bodies of ``src/repro_torch/csrc/*.cu`` run here unchanged,
minus their host launchers.  This checks the kernels' logic — operation
order, indexing, the serial chain and the block-wide scans — on every
run; the card itself checks compilation for sm_90a and real
concurrency (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Skips
when no C++20 host compiler is available.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import (VARIANTS, HeapConfig, Ouroboros, arena,
                              defrag, shards)
from repro_torch.core import transactions as T
from repro_torch.kernels import ref
from repro_torch.kernels import alloc_txn as AT
from repro_torch.kernels import defrag_txn as DT
from repro_torch.kernels.alloc_txn import (CHAIN_STATS, FREE_STATS,
                                           SHARD_STATS, TABLE_SMEM_LIMIT,
                                           ArenaDesc, descriptor)
from repro_torch.kernels.defrag_txn import REBUILD_STATS
from repro_torch.paged.kv_cache import _quant

# every allocator and wave kernel's launch count, in the harness's order
LAUNCHES = AT.LAUNCH_STATS + DT.LAUNCH_STATS

ROOT = pathlib.Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
MARK = "// ---- host launchers"


def _device_part(src: str) -> str:
    """Kernel source without its host launchers; the dynamic shared
    array points at the emulation's per-launch buffer."""
    assert MARK in src, "kernel source lost its host-launcher marker"
    src = src[:src.index(MARK)]
    return re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_dyn_smem;", src)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "alloc_emu.inc").write_text(
        _device_part((CSRC / "alloc_txn.cu").read_text()))
    (out / "defrag_emu.inc").write_text(
        _device_part((CSRC / "defrag_txn.cu").read_text()))
    (out / "attention_emu.inc").write_text(
        _device_part((CSRC / "paged_attention.cu").read_text()))
    (out / "ssd_emu.inc").write_text(
        _device_part((CSRC / "ssd_scan.cu").read_text()))
    (out / "ring_emu.inc").write_text(
        _device_part((CSRC / "ring_txn.cu").read_text()))
    (out / "bitmap_emu.inc").write_text(
        _device_part((CSRC / "bitmap_txn.cu").read_text()))
    lib = out / "libemu.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           f"-I{EMU / 'include'}", f"-I{EMU}", f"-I{out}", f"-I{CSRC}",
           "-o", str(lib),
           str(EMU / "harness.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "c++20" in r.stderr.lower():
        pytest.skip(f"host compiler lacks C++20: {r.stderr[:200]}")
    assert r.returncode == 0, r.stderr
    so = ctypes.CDLL(str(lib))
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    so.emu_alloc_txn.argtypes = [ArenaDesc, P, P, P, P, I, P, Z]
    so.emu_free_txn.argtypes = [ArenaDesc, P, P, P, P, P, I, Z]
    so.emu_defrag_txn.argtypes = [ArenaDesc, P, P, P, P, P, I, I, Z]
    so.emu_paged_attention.argtypes = [I, I, P, P, P, P, P, P] + [I] * 8 + [
        ctypes.c_float]
    so.emu_paged_attention_window.argtypes = [I, I] + [P] * 6 + [I] * 10 + [
        ctypes.c_float]
    so.emu_paged_attention_int8.argtypes = [I, I] + [P] * 8 + [I] * 10 + [
        ctypes.c_float]
    so.emu_sharded_alloc_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                         I, I, P, Z]
    so.emu_sharded_free_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                        I, Z]
    so.emu_sharded_defrag_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                          I, I, Z]
    so.defrag_txn_workspace_bytes.argtypes = [ArenaDesc, I, Z]
    so.defrag_txn_workspace_bytes.restype = Z
    so.sharded_alloc_txn_grid.argtypes = [ArenaDesc, I, Z]
    so.sharded_alloc_txn_grid.restype = I
    so.emu_ssd_scan.argtypes = [I] + [P] * 8 + [I] * 8
    for name in ("alloc_txn", "sharded_alloc_txn"):
        fn = getattr(so, f"{name}_workspace_bytes")
        fn.argtypes, fn.restype = [ArenaDesc, I, Z], Z
    so.free_txn_workspace_bytes.argtypes = [ArenaDesc, I, I, Z]
    so.free_txn_workspace_bytes.restype = Z
    so.emu_ring_txn_pop.argtypes = [P] * 5 + [I] * 4 + [P] * 2
    so.emu_ring_txn_push.argtypes = [P] * 5 + [I] * 3 + [P]
    so.emu_ring_window.argtypes = [P] * 3 + [I] * 3 + [P]
    so.emu_chunk_txn_claim.argtypes = [P] + [I] * 3 + [P] * 3
    so.emu_bitmap_select.argtypes = [P, I, I, P]
    so.emu_alloc_chain_stats.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), I]
    so.emu_alloc_chain_stats.restype = I
    so.emu_free_enqueue_stats.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), I]
    so.emu_free_enqueue_stats.restype = I
    for name in ("emu_alloc_shard_stats", "emu_defrag_rebuild_stats",
                 "emu_launch_stats", "emu_ring_launch_stats"):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), I]
        fn.restype = I
    for f in (so.emu_alloc_txn, so.emu_free_txn, so.emu_defrag_txn,
              so.emu_paged_attention, so.emu_paged_attention_window,
              so.emu_paged_attention_int8,
              so.emu_sharded_alloc_txn,
              so.emu_sharded_free_txn, so.emu_sharded_defrag_txn,
              so.emu_ssd_scan, so.emu_ring_txn_pop, so.emu_ring_txn_push,
              so.emu_ring_window, so.emu_chunk_txn_claim,
              so.emu_bitmap_select):
        f.restype = None
    return so


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


# A lowered shared-memory limit for the lane tables: every transaction
# of a small trace then keeps its tables in the device workspace, as a
# transaction of hundreds of thousands of lanes does at the real limit.
SPILL = 16


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


# a sharded arena of the engine's geometry: 4 shards x 12 chunks
SHARD_CFG = dict(total_bytes=4 * 12 * 4096, chunk_bytes=4096,
                 min_page_bytes=256)


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


def _stats(fn, names) -> dict:
    """An emulated kernel family's device counters, read and cleared."""
    buf = (ctypes.c_ulonglong * len(names))()
    assert fn(buf, 1) == len(names)
    return dict(zip(names, (int(v) for v in buf)))


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


# ---- the other five variants: page kinds, ring and va families -------------

OTHER_VARIANTS = ("page", "chunk", "va_page", "vl_page", "va_chunk")
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


# ---- the chunk chain's whole-chunk runs ------------------------------------

CHUNK_VARIANTS = ("chunk", "va_chunk", "vl_chunk")
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


def _run_lanes(rng, n, size, other, p_other=0.15, p_off=0.05):
    """``n`` lanes, most of ``size`` bytes, some of ``other``, a few
    masked off."""
    sizes = np.where(rng.random(n) < p_other, other, size).astype(np.int32)
    return (torch.from_numpy(sizes),
            torch.from_numpy(rng.random(n) >= p_off))


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


def _free_stats(emu):
    """The emulated free kernels' enqueue statistics since the last call
    (read and cleared), by ``FREE_STATS`` name."""
    buf = (ctypes.c_ulonglong * len(FREE_STATS))()
    assert emu.emu_free_enqueue_stats(buf, 1) == len(FREE_STATS)
    return dict(zip(FREE_STATS, (int(v) for v in buf)))


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


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_kernel_matches_plain(emu, dtype, wpp):
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D, page, P, NP = 4, 14, 2, 64, 16, 6, 40
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[0, 2] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    seq = np.array([P * page, 0, 37, 1], np.int32)
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    tt, st = torch.from_numpy(table), torch.from_numpy(seq)
    want = ref.paged_attention(q, k, v, tt, st, wpp=wpp)
    got = torch.empty((B, Hq, D), dtype=torch.float32)
    emu.emu_paged_attention(int(dtype == torch.bfloat16), 1, _p(q), _p(k),
                            _p(v), _p(tt), _p(st), _p(got), B, Hq, Hkv, D,
                            page, P, NP, int(wpp or 0), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


# (B, Hq, Hkv, D, page, P, NP, seq_lens, holes as (row, first page, last
# page + 1)); splits of 64 tokens: 4 pages of 16, 8 of 8
SPLIT_CASES = {
    # 4 splits (the last of one page); lengths 0, 1, a split's exact
    # multiple, P * page, ragged; a hole inside a live split, a split
    # of holes, holes past the live range
    "qwen2-heads": (6, 14, 2, 64, 16, 13, 90,
                    [0, 1, 64, 13 * 16, 100, 37],
                    [(4, 2, 3), (3, 4, 8), (5, 5, 13), (2, 1, 2)]),
    # rows of 24 bytes in bf16 (not 16-byte chunks): element copies
    "narrow-rows": (3, 4, 1, 12, 8, 11, 40, [88, 9, 0],
                    [(0, 3, 4), (1, 2, 11)]),
    # a table of no pages: one split a sequence, every output 0
    "no-pages": (2, 4, 2, 16, 16, 0, 4, [0, 5], []),
}


@pytest.mark.parametrize("case", tuple(SPLIT_CASES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_split_kernel_matches_plain(emu, case, dtype, wpp):
    """The split kernels and the fold over pages: pages split across
    blocks (a split past the sequence exits, a split of holes adds
    nothing), ragged lengths, holes inside and past the live range, both
    table modes and dtypes, 16-byte and element copies: atol 1e-5 of the
    plain version on the same (widened) values."""
    B, Hq, Hkv, D, page, P, NP, seq, holes = SPLIT_CASES[case]
    rng = np.random.default_rng(P)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    tt = torch.from_numpy(table)
    st = torch.tensor(seq, dtype=torch.int32)
    want = ref.paged_attention(q, k, v, tt, st, wpp=wpp)
    vec = (D * k.element_size()) % 16 == 0
    assert vec == (case != "narrow-rows" or dtype == torch.float32)
    got = torch.full((B, Hq, D), float("nan"), dtype=torch.float32)
    emu.emu_paged_attention(int(dtype == torch.bfloat16), int(vec), _p(q),
                            _p(k), _p(v), _p(tt), _p(st), _p(got), B, Hq,
                            Hkv, D, page, P, NP, int(wpp or 0),
                            1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert not bool(got[(st == 0) | (P == 0)].any())   # no token: 0


# (B, Hq, Hkv, D, page, P, NP, seq_lens, window, ring, holes): windows
# and ring tables at mixtral's head shape (G 4, D 128) and at narrow rows
WINDOW_CASES = {
    # a 96-token window: its first token on a split boundary (160, 224),
    # one past it (161), inside a page (100), longer than the sequence
    # (64); a hole inside the window, holes only before it
    "mixtral-heads-window": (6, 8, 2, 128, 16, 16, 200,
                             [0, 64, 100, 160, 161, 224], 96, False,
                             [(3, 0, 4), (4, 7, 8), (5, 2, 9)]),
    # ring tables of 10 slots (window // page + 2, as mixtral's 258):
    # sequences that do not wrap (16, 159), that end on a lap's last
    # token (160), start the next lap (161) and wrap several times (1000,
    # 4097), with holes
    "mixtral-heads-ring": (6, 8, 2, 128, 16, 10, 120,
                           [16, 159, 160, 161, 1000, 4097], 128,
                           True, [(3, 4, 5), (5, 0, 2)]),
    # a ring without a window: every slot of the last lap is attended
    "ring-no-window": (4, 8, 2, 64, 16, 6, 40, [0, 70, 96, 333], None, True,
                       [(3, 1, 2)]),
    # rows of 24 bytes in bf16 (element copies), pages of 8, a window of
    # 20 tokens inside a ring of 5 slots
    "narrow-ring-window": (3, 4, 1, 12, 8, 5, 30, [7, 41, 200], 20, True,
                           [(2, 3, 4)]),
}


@pytest.mark.parametrize("case", tuple(WINDOW_CASES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_window_ring_kernel_matches_plain(emu, case, dtype,
                                                          wpp):
    """``window`` and ``ring`` in the split kernels and the fold: windows
    whose edges fall on split boundaries and inside pages, ring tables
    shorter than the sequence that wrap, holes, both table modes and
    dtypes, D = 128 at G = 4: atol 1e-5 of the plain version on the same
    (widened) values.  Slots before the window or off the ring's last
    lap are loaded by no split."""
    B, Hq, Hkv, D, page, P, NP, seq, window, ring, holes = \
        WINDOW_CASES[case]
    rng = np.random.default_rng(NP)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    tt = torch.from_numpy(table)
    st = torch.tensor(seq, dtype=torch.int32)
    want = ref.paged_attention(q, k, v, tt, st, wpp=wpp, window=window,
                               ring=ring)
    vec = (D * k.element_size()) % 16 == 0
    got = torch.full((B, Hq, D), float("nan"), dtype=torch.float32)
    emu.emu_paged_attention_window(
        int(dtype == torch.bfloat16), int(vec), _p(q), _p(k), _p(v), _p(tt),
        _p(st), _p(got), B, Hq, Hkv, D, page, P, NP, int(wpp or 0),
        int(window or 0), int(ring), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert not bool(got[st == 0].any())   # no token: 0
    # the window and the ring change what is attended in these cases
    plain = ref.paged_attention(q, k, v, tt, st, wpp=wpp)
    assert float((plain - want).abs().max()) > 1e-3


# (B, Hq, Hkv, D, page, P, NP, seq_lens, window, ring, wpp, holes): int8
# pages with per-(slot, head) scales at G = 1 (qwen1.5-32b's heads, D
# 128), 4 and 7, D 32-128, both table modes, a window, a wrapping ring,
# and rows of 24 int8 elements (element copies)
INT8_CASES = {
    "g1-d128": (3, 2, 2, 128, 16, 5, 24, [0, 37, 80], None, False, None,
                [(2, 1, 2)]),
    "g4-d64-offsets": (4, 8, 2, 64, 16, 6, 40, [96, 1, 50, 70], None, False,
                       64, [(0, 2, 3), (3, 4, 6)]),
    "g7-d32": (3, 14, 2, 32, 16, 5, 30, [80, 17, 64], None, False, None,
               [(1, 0, 1)]),
    "g4-d128-window": (4, 8, 2, 128, 16, 12, 60, [20, 100, 161, 190], 96,
                       False, 64, [(2, 3, 5), (3, 0, 4)]),
    "g1-d128-ring": (4, 2, 2, 128, 16, 10, 50, [16, 160, 161, 1000], 128,
                     True, None, [(3, 4, 5)]),
    "narrow-rows": (2, 2, 1, 24, 8, 5, 20, [33, 7], None, False, 64,
                    [(0, 3, 4)]),
}


def _int8_inputs(case, q_dtype):
    """Unit-normal q in ``q_dtype`` and K, V quantized as the KV cache
    stores them (``kv_cache._quant``: int8 words, a float32 scale per
    (page, slot, kv head)), a permuted table with holes."""
    B, Hq, Hkv, D, page, P, NP, seq, window, ring, wpp, holes = \
        INT8_CASES[case]
    rng = np.random.default_rng(NP + D)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k8, ks = _quant(torch.from_numpy(
        rng.standard_normal((NP, page, Hkv, D), np.float32)))
    v8, vs = _quant(torch.from_numpy(
        rng.standard_normal((NP, page, Hkv, D), np.float32)))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    return (q.to(q_dtype).contiguous(), k8, v8, ks, vs,
            torch.from_numpy(table), torch.tensor(seq, dtype=torch.int32),
            dict(wpp=wpp, window=window, ring=ring))


def _emu_int8(so, q, k8, v8, ks, vs, tt, st, wpp, window, ring):
    B, Hq, D = q.shape
    NP, page, Hkv, _ = k8.shape
    got = torch.full((B, Hq, D), float("nan"), dtype=torch.float32)
    so.emu_paged_attention_int8(
        int(q.dtype == torch.bfloat16), int(D % 16 == 0), _p(q), _p(k8),
        _p(v8), _p(ks), _p(vs), _p(tt), _p(st), _p(got), B, Hq, Hkv, D, page,
        tt.shape[1], NP, int(wpp or 0), int(window or 0), int(ring),
        1.0 / D ** 0.5)
    return got


@pytest.mark.parametrize("case", tuple(INT8_CASES))
@pytest.mark.parametrize("q_dtype", (torch.float32, torch.bfloat16))
def test_paged_attention_int8_kernel_matches_plain(emu, case, q_dtype):
    """int8 pages in the split kernels and the fold: each element read
    as float(k8) * scale of its (page, slot, kv head), q in float32 and
    bf16, G 1, 4 and 7, D 24-128 (16-byte chunks of 16 int8 elements,
    or element copies), both table modes, a window and a wrapping ring,
    holes and ragged lengths: atol 1e-5 of the plain version on the same
    values."""
    q, k8, v8, ks, vs, tt, st, kw = _int8_inputs(case, q_dtype)
    want = ref.paged_attention(q, k8, v8, tt, st, k_scale=ks, v_scale=vs,
                               **kw)
    got = _emu_int8(emu, q, k8, v8, ks, vs, tt, st, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert not bool(got[st == 0].any())   # no token: 0
    # the scales matter: the words alone give another result
    ones = torch.ones_like(ks)
    words = ref.paged_attention(q, k8, v8, tt, st, k_scale=ones,
                                v_scale=ones, **kw)
    assert float((words - want).abs().max()) > 1e-3


# one-line mutations of the kernel source's scale read: the slot or the
# kv head of a token's scale off by one
SCALE_MUTATIONS = {
    "wrong-slot": ("(id * page + u % page) * Hkv + h]",
                   "(id * page + (u + 1) % page) * Hkv + h]"),
    "wrong-head": ("(id * page + u % page) * Hkv + h]",
                   "(id * page + u % page) * Hkv + (h + 1) % Hkv]"),
}


@pytest.mark.parametrize("mutation", tuple(SCALE_MUTATIONS))
def test_paged_attention_int8_scale_mutation_fails(mutation,
                                                   tmp_path_factory):
    """The int8 cases catch a scale read from the wrong slot or head: the
    attention kernels alone (``cuda_emu/attention_harness.cpp``) built
    from a mutated copy of the source give an error far past the
    tolerance on two of the cases above."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / "paged_attention.cu").read_text()
    old, new = SCALE_MUTATIONS[mutation]
    assert src.count(old) == 1, "the scale read moved: update the mutation"
    out = tmp_path_factory.mktemp("cuda_emu_mutant")
    (out / "attention_emu.inc").write_text(
        _device_part(src.replace(old, new)))
    lib = out / "libattention.so"
    r = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{EMU / 'include'}", f"-I{EMU}",
                        f"-I{out}", "-o", str(lib),
                        str(EMU / "attention_harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "c++20" in r.stderr.lower():
        pytest.skip(f"host compiler lacks C++20: {r.stderr[:200]}")
    assert r.returncode == 0, r.stderr
    so = ctypes.CDLL(str(lib))
    so.emu_paged_attention_int8.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float]
    so.emu_paged_attention_int8.restype = None
    for case in ("g4-d64-offsets", "g1-d128-ring"):
        q, k8, v8, ks, vs, tt, st, kw = _int8_inputs(case, torch.float32)
        want = ref.paged_attention(q, k8, v8, tt, st, k_scale=ks,
                                   v_scale=vs, **kw)
        got = _emu_int8(so, q, k8, v8, ks, vs, tt, st, **kw)
        assert float((got - want).abs().max()) > 1e-3, case


def _ssd_inputs(rng, B, L, H, P, G, N, dtype, with_h0):
    """Mamba-2-like inputs: softplus steps around the reference's init
    (dt_bias -3), a = -exp(log 4), unit-variance x, B and C."""
    x = torch.from_numpy(rng.standard_normal((B, L, H, P), np.float32))
    raw = rng.standard_normal((B, L, H)).astype(np.float32) - 3.0
    dt = torch.nn.functional.softplus(torch.from_numpy(raw))
    a = -torch.exp(torch.from_numpy(
        (np.log(4.0) + 0.3 * rng.standard_normal(H)).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal((B, L, G, N), np.float32))
    c = torch.from_numpy(rng.standard_normal((B, L, G, N), np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((B, H, P, N), np.float32))
          if with_h0 else None)
    x, b, c = (t.to(dtype).contiguous() for t in (x, b, c))
    return x, dt, a, b, c, h0


H100_SMS = 132


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,L,H,P,G,N,Q,with_h0,sms", [
    (1, 128, 2, 64, 1, 128, 64, True, H100_SMS),  # mamba2-780m's heads
    # the same on a card of one SM: each head's state in one block
    (1, 128, 2, 64, 1, 128, 64, True, 1),
    (2, 48, 4, 16, 2, 32, 16, False, H100_SMS),  # the smoke config, G 2
    (1, 24, 3, 8, 3, 16, 8, True, H100_SMS),     # G == H, tiles half empty
    (1, 16, 4, 16, 1, 32, 16, False, H100_SMS),  # one chunk, zero state
    (2, 16, 4, 16, 2, 32, 16, True, H100_SMS),   # one chunk from h0
    (1, 32, 4, 16, 2, 32, 16, True, H100_SMS),   # two chunks, G 2, h0
    (2, 48, 2, 24, 1, 40, 16, True, H100_SMS),   # three chunks, N past a tile
    (1, 60, 4, 12, 2, 20, 20, False, H100_SMS),  # Q and N off the 16 tiles
    (1, 24, 2, 6, 1, 10, 12, True, H100_SMS),    # P, N off the 4-wide stores
], ids=("full-width-heads", "full-width-heads-whole-blocks", "smoke-groups",
        "small", "one-chunk", "one-chunk-h0", "two-chunks-h0",
        "three-chunks-ragged-n", "ragged-q", "ragged-p"))
def test_ssd_scan_kernel_matches_plain(emu, dtype, B, L, H, P, G, N, Q,
                                       with_h0, sms):
    """The emulated ``ssd_scan`` against ``ssd_plain`` on the same
    values (bf16 inputs are widened to float32 by both): atol and rtol
    1e-4, the same float32 products summed in another order."""
    from repro_torch.kernels.ssd_scan import ssd_plain
    rng = np.random.default_rng(B * 100 + L)
    x, dt, a, b, c, h0 = _ssd_inputs(rng, B, L, H, P, G, N, dtype, with_h0)
    want_y, want_h = ssd_plain(x, dt, a, b, c, Q, h0)
    y = torch.empty((B, L, H, P), dtype=torch.float32)
    hf = torch.empty((B, H, P, N), dtype=torch.float32)
    emu.emu_ssd_scan(int(dtype == torch.bfloat16), _p(x), _p(dt), _p(a),
                     _p(b), _p(c), None if h0 is None else _p(h0), _p(y),
                     _p(hf), B, L, H, P, G, N, Q, sms)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hf.numpy(), want_h.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---- the piecewise allocator's steps (csrc/ring_txn.cu, bitmap_txn.cu) -----

def _bool(a):
    return torch.from_numpy(np.asarray(a, dtype=bool))


def _i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


# (lanes, classes, ring capacity, counter base, the one class of every
# lane or None for random ones): counters past 2^31 (wrapped negative),
# and just below it (ranks carry them across), for ring rows of every
# size the allocator uses, on each path the launchers pick: one warp for
# 32 lanes or fewer (the chunk drain's 1-lane pops of a class ring and of
# the pool, C = 1), one block ranking every class above that (33 lanes,
# and 1100, 4096, 6000 and init's one-class push of 684 chunks x 16
# pages, 10,944 lanes, for its batches of 2, 4, 8 and 16 groups a warp
# in one pass; 20,000 lanes in two), one block per class past 32
# classes.  Random lanes mix classes, masked lanes and the
# classes -1 and C within a tile of 32.
RING_CASES = [(16, 3, 48, 0, None), (4096, 5, 1024, -2 ** 31 + 7, None),
              (4096, 5, 1000, 2 ** 31 - 300, None),
              (1, 5, 48, -2 ** 31 + 7, 4), (1, 1, 64, 2 ** 31 - 2, 0),
              (32, 32, 40, 2 ** 31 - 50, None), (33, 5, 48, -2 ** 31 + 3,
                                                 None),
              (33, 32, 40, 0, None), (40, 33, 40, 2 ** 31 - 60, None),
              (1100, 3, 512, -2 ** 31 + 100, None),
              (6000, 5, 2000, 2 ** 31 - 1000, None),
              (10944, 5, 10944, 2 ** 31 - 5000, 0),
              (20000, 5, 5000, -2 ** 31 + 11, None)]
RING_IDS = ("16-lanes", "4096-lanes-wrapped", "4096-lanes-crossing",
            "1-lane-wrapped", "1-lane-pool-crossing", "32-lanes-32-classes",
            "33-lanes-wrapped", "33-lanes-32-classes",
            "40-lanes-33-classes-crossing", "1100-lanes-wrapped",
            "6000-lanes-crossing", "10944-lanes-one-class",
            "20000-lanes-wrapped")


def _ring_path(n, C):
    """The kernel path the launchers pick (csrc/ring_txn.cu, ring_path)."""
    return "class" if C > 32 else "warp" if n <= 32 else "block"


def _ring_inputs(n, C, cap, base, seed, one=None):
    rng = np.random.default_rng(seed)
    store = _i32(rng.integers(0, 10 ** 6, (C, cap)))
    front = base + rng.integers(0, 3 * cap, C)
    if one is None:
        back = front + rng.integers(0, cap + 1, C)
        # lanes of the classes -1 and C lie outside [0, C)
        cls = _i32(rng.integers(-1, C + 1, n))
        valid = _bool(rng.random(n) < 0.8)
    else:
        back = front + rng.integers(1, cap + 1, C)
        cls = _i32(np.full(n, one))
        valid = _bool(np.ones(n, bool))
    return store, _i32(front), _i32(back), cls, valid


def _ring_ran(emu, n, C, kind):
    """The ring launches since the last read, which must be one of
    ``kind`` ("pop" or "push") on the path the launchers pick."""
    ran = {k: v for k, v in _stats(emu.emu_ring_launch_stats,
                                   AT.RING_LAUNCH_STATS).items() if v}
    assert ran == {f"ring_txn_{kind}_{_ring_path(n, C)}": 1}, ran


@pytest.mark.parametrize("limit", (True, False), ids=("limit", "pool"))
@pytest.mark.parametrize("n,C,cap,base,one", RING_CASES, ids=RING_IDS)
def test_ring_txn_pop_kernel_matches_plain(emu, n, C, cap, base, one,
                                           limit):
    """The emulated ``ring_txn_pop`` on the path its launcher picks (one
    warp, one block ranking every class by ``rank_lanes``, or one block
    per class), as its own launch count says, gives the plain version's
    values and fronts: masked lanes and lanes of an out-of-range class
    read −1, ``limit`` grants the inventory's rank prefix."""
    store, front, back, cls, valid = _ring_inputs(n, C, cap, base, n + C,
                                                  one)
    want_v, want_f = ref.ring_txn_pop_ref(store, front, back, cls, valid,
                                          limit)
    vals = torch.full((n,), 12345, dtype=torch.int32)
    nf = torch.empty(C, dtype=torch.int32)
    _stats(emu.emu_ring_launch_stats, AT.RING_LAUNCH_STATS)
    emu.emu_ring_txn_pop(_p(store), _p(front), _p(back), _p(cls), _p(valid),
                         n, C, cap, int(limit), _p(vals), _p(nf))
    _ring_ran(emu, n, C, "pop")
    assert torch.equal(vals, want_v) and torch.equal(nf, want_f)
    assert int((want_v >= 0).sum()) > 0
    if one is None:
        assert int((want_v < 0).sum()) > 0


@pytest.mark.parametrize("n,C,cap,base,one", RING_CASES, ids=RING_IDS)
def test_ring_txn_push_kernel_matches_plain(emu, n, C, cap, base, one):
    """The emulated ``ring_txn_push`` on the path its launcher picks
    writes the plain version's store in place (only its members' slots)
    and its backs."""
    store, _, back, cls, valid = _ring_inputs(n, C, cap, base, 2 * n + C,
                                              one)
    counts = torch.bincount(cls[valid & (cls >= 0) & (cls < C)].long(),
                            minlength=C)
    assert int(counts.max()) <= cap
    vals = _i32(np.random.default_rng(n).integers(0, 10 ** 6, n))
    want_s, want_b = ref.ring_txn_push_ref(store.clone(), back, cls, vals,
                                           valid)
    got_s = store.clone()
    nb = torch.empty(C, dtype=torch.int32)
    _stats(emu.emu_ring_launch_stats, AT.RING_LAUNCH_STATS)
    emu.emu_ring_txn_push(_p(got_s), _p(back), _p(cls), _p(vals), _p(valid),
                          n, C, cap, _p(nb))
    _ring_ran(emu, n, C, "push")
    assert torch.equal(got_s, want_s) and torch.equal(nb, want_b)
    assert not torch.equal(got_s, store)


@pytest.mark.parametrize("C,cap,m,base", [
    (5, 256, 100, -2 ** 31 + 3), (3, 1024, 1024, 2 ** 31 - 600),
    (1, 32, 8, 30)], ids=("wrapped", "full-ring-crossing", "small"))
def test_ring_window_kernel_matches_plain(emu, C, cap, m, base):
    """The emulated ``ring_window`` (a grid of tiles x classes) gives
    the plain window, wrapped rows and empty classes included."""
    rng = np.random.default_rng(cap)
    store = _i32(rng.integers(0, 10 ** 6, (C, cap)))
    front = _i32(base + rng.integers(0, 2 * cap, C))
    counts = _i32(rng.integers(0, m + 1, C))
    counts[0] = 0
    want = ref.ring_window_ref(store, front, counts, m)
    got = torch.empty((C, m), dtype=torch.int32)
    emu.emu_ring_window(_p(store), _p(front), _p(counts), C, cap, m,
                        _p(got))
    assert torch.equal(got, want)


@pytest.mark.parametrize("bw,ppc", [(1, 16), (1, 32), (4, 128),
                                    (1100, 1100 * 32 - 5)],
                         ids=("ppc-16", "ppc-32", "4-words", "2-tiles"))
def test_chunk_txn_claim_kernel_matches_plain(emu, bw, ppc):
    """The emulated ``chunk_txn_claim`` gives the plain claim's page
    indices, row and count for takes of 0, a few, and past the free
    bits, on a row spanning two tiles of 1024 words."""
    rng = np.random.default_rng(bw)
    for take in (0, 3, 40, 10 ** 6):
        row = _i32(rng.integers(0, 2 ** 32, bw, dtype=np.uint64)
                   .astype(np.uint32).view(np.int32))
        want = ref.chunk_txn_claim_ref(row, take, ppc)
        pidx = torch.full((32 * bw,), 777, dtype=torch.int32)
        nrow = torch.empty(bw, dtype=torch.int32)
        nsel = torch.empty(1, dtype=torch.int32)
        emu.emu_chunk_txn_claim(_p(row), bw, take, ppc, _p(pidx), _p(nrow),
                                _p(nsel))
        for g, w in zip((pidx, nrow, nsel), want):
            assert torch.equal(g, w), take


@pytest.mark.parametrize("W", (32, 64, 1056),
                         ids=("32-words", "64-words", "1056-words-2-tiles"))
def test_bitmap_select_kernel_matches_plain(emu, W):
    """The emulated ``bitmap_select`` gives the plain rank map with the
    prefix carried across tiles of 1024 words, for k of 0, 1, 100 and
    past every set bit."""
    rng = np.random.default_rng(W)
    words = _i32(rng.integers(0, 2 ** 32, W, dtype=np.uint64)
                 .astype(np.uint32).view(np.int32))
    for k in (0, 1, 100, 10 ** 6):
        want = ref.bitmap_select_ref(words, k)
        got = torch.empty(32 * W, dtype=torch.int32)
        emu.emu_bitmap_select(_p(words), W, k, _p(got))
        assert torch.equal(got, want), k
