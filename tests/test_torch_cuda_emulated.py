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
from repro_torch.kernels import ref
from repro_torch.kernels.alloc_txn import (TABLE_SMEM_LIMIT, ArenaDesc,
                                           descriptor)

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
    so.emu_paged_attention.argtypes = [I, P, P, P, P, P, P] + [I] * 8 + [
        ctypes.c_float]
    so.emu_sharded_alloc_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                         I, I, P, Z]
    so.emu_sharded_free_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                        I, Z]
    so.emu_sharded_defrag_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                          I, I, Z]
    so.defrag_txn_workspace_bytes.argtypes = [ArenaDesc, Z]
    so.defrag_txn_workspace_bytes.restype = Z
    so.emu_ssd_scan.argtypes = [I] + [P] * 8 + [I] * 7
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
    for f in (so.emu_alloc_txn, so.emu_free_txn, so.emu_defrag_txn,
              so.emu_paged_attention, so.emu_sharded_alloc_txn,
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


def _emu_sharded_wave(emu, o, st, src, dst, sizes, threads=256,
                      limit=TABLE_SMEM_LIMIT):
    slay = o.layout
    mem, ctl = st.mem.clone(), st.ctl.clone()
    d = descriptor(slay.shard)
    assert (emu.defrag_txn_workspace_bytes(d, limit) > 0) == (limit == SPILL)
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
    assert (emu.defrag_txn_workspace_bytes(d, limit) > 0) == (limit == SPILL)
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
    emu.emu_paged_attention(int(dtype == torch.bfloat16), _p(q), _p(k),
                            _p(v), _p(tt), _p(st), _p(got), B, Hq, Hkv, D,
                            page, P, NP, int(wpp or 0), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


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


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,L,H,P,G,N,Q,with_h0", [
    (1, 128, 2, 64, 1, 128, 64, True),    # mamba2-780m's head shapes
    (2, 48, 4, 16, 2, 32, 16, False),     # the smoke config, two groups
    (1, 24, 3, 8, 3, 16, 8, True),        # G == H, tiles half empty
], ids=("full-width-heads", "smoke-groups", "small"))
def test_ssd_scan_kernel_matches_plain(emu, dtype, B, L, H, P, G, N, Q,
                                       with_h0):
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
                     _p(hf), B, L, H, P, G, N, Q)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hf.numpy(), want_h.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---- the piecewise allocator's steps (csrc/ring_txn.cu, bitmap_txn.cu) -----

def _bool(a):
    return torch.from_numpy(np.asarray(a, dtype=bool))


def _i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


# counters past 2^31 (wrapped negative), and just below it (ranks carry
# them across), for ring rows of every size the allocator uses
RING_CASES = [(16, 3, 48, 0), (4096, 5, 1024, -2 ** 31 + 7),
              (4096, 5, 1000, 2 ** 31 - 300)]
RING_IDS = ("16-lanes", "4096-lanes-wrapped", "4096-lanes-crossing")


def _ring_inputs(n, C, cap, base, seed):
    rng = np.random.default_rng(seed)
    store = _i32(rng.integers(0, 10 ** 6, (C, cap)))
    front = base + rng.integers(0, 3 * cap, C)
    back = front + rng.integers(0, cap + 1, C)
    # lanes of the classes -1 and C lie outside [0, C)
    cls = _i32(rng.integers(-1, C + 1, n))
    valid = _bool(rng.random(n) < 0.8)
    return store, _i32(front), _i32(back), cls, valid


@pytest.mark.parametrize("limit", (True, False), ids=("limit", "pool"))
@pytest.mark.parametrize("n,C,cap,base", RING_CASES, ids=RING_IDS)
def test_ring_txn_pop_kernel_matches_plain(emu, n, C, cap, base, limit):
    """The emulated ``ring_txn_pop`` (one block per class, ranks by a
    block scan carried over tiles of 1024 lanes) gives the plain
    version's values and fronts: masked lanes and lanes of an
    out-of-range class read −1, ``limit`` grants the inventory's rank
    prefix."""
    store, front, back, cls, valid = _ring_inputs(n, C, cap, base, n + C)
    want_v, want_f = ref.ring_txn_pop_ref(store, front, back, cls, valid,
                                          limit)
    vals = torch.full((n,), 12345, dtype=torch.int32)
    nf = torch.empty(C, dtype=torch.int32)
    emu.emu_ring_txn_pop(_p(store), _p(front), _p(back), _p(cls), _p(valid),
                         n, C, cap, int(limit), _p(vals), _p(nf))
    assert torch.equal(vals, want_v) and torch.equal(nf, want_f)
    assert int((want_v >= 0).sum()) > 0 and int((want_v < 0).sum()) > 0


@pytest.mark.parametrize("n,C,cap,base", RING_CASES, ids=RING_IDS)
def test_ring_txn_push_kernel_matches_plain(emu, n, C, cap, base):
    """The emulated ``ring_txn_push`` writes the plain version's store
    in place (only its members' slots) and its backs."""
    store, _, back, cls, valid = _ring_inputs(n, C, cap, base, 2 * n + C)
    counts = torch.bincount(cls[valid & (cls >= 0) & (cls < C)].long(),
                            minlength=C)
    assert int(counts.max()) <= cap
    vals = _i32(np.random.default_rng(n).integers(0, 10 ** 6, n))
    want_s, want_b = ref.ring_txn_push_ref(store.clone(), back, cls, vals,
                                           valid)
    got_s = store.clone()
    nb = torch.empty(C, dtype=torch.int32)
    emu.emu_ring_txn_push(_p(got_s), _p(back), _p(cls), _p(vals), _p(valid),
                          n, C, cap, _p(nb))
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
