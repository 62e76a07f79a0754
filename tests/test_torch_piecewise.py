"""The port's piecewise allocator API held to the JAX reference.

The reference's ``page_alloc``/``chunk_alloc`` state machines over the
``ring``, ``va`` and ``vl`` queue families route each device step
through a Pallas kernel with ``backend="pallas"`` (run here in interpret
mode, as ``tests/test_kernels.py`` runs them) and through jnp with
``"jnp"``; the port's counterparts do so with ``piecewise=True`` (the
plain versions of the CUDA kernels, on the CPU) and without it.  All
four must give the same offsets and the same state words after every
transaction.  The five ``kernels/ops`` steps are held to the
reference's ops on its own kernel-test cases, wrapped counters, empty
classes, ``k`` 0 and lanes of an out-of-range class.  Last, with the
five steps made to raise, the transaction math, a defragmentation
wave, a sharded transaction and the serving engine run unharmed: only
the piecewise route reaches them.  Every comparison is exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import HeapConfig as JHeapConfig
from repro.core import chunk_alloc as jchunk
from repro.core import page_alloc as jpage
from repro.kernels import ops as jops

from repro_torch.core import HeapConfig, Ouroboros, arena, chunk_alloc, \
    page_alloc, transactions
from repro_torch.kernels import ops

VARIANTS = [(k, f) for k in ("page", "chunk") for f in ("ring", "va", "vl")]
VIDS = [f"{f}_{k}" for k, f in VARIANTS]
# one geometry for every variant: 32 chunks of 2 KiB, 8 classes of
# 16 B .. 2 KiB pages, 4 bitmap words a chunk
CFG = dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16)
MENU = [16, 24, 64, 100, 256, 1000, 2048, 4096]   # 4096 B is over-large
LANES = 16
MODS = {"page": (jpage, page_alloc), "chunk": (jchunk, chunk_alloc)}


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def _eq(port, want, what):
    got = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(_u32(got), _u32(want), err_msg=what)


def _words(a):
    """numpy int32 words (uint32 bitmaps as their bit patterns)."""
    return np.asarray(a).astype(np.uint32).view(np.int32) \
        if np.asarray(a).dtype == np.uint32 else np.asarray(a)


# ---- the five steps against the reference's ops ----------------------------

@pytest.mark.parametrize("C,cap,m,base", [
    (1, 64, 16, 0), (5, 256, 64, 0), (10, 1024, 1024, 0), (3, 128, 128, 0),
    (4, 96, 40, -2 ** 31 + 5)],
    ids=("1x64", "5x256", "10x1024", "3x128", "wrapped"))
def test_ring_window_matches_reference(C, cap, m, base):
    rng = np.random.default_rng(C * cap)
    store = rng.integers(0, 10 ** 6, (C, cap)).astype(np.int32)
    front = (base + rng.integers(0, cap, C)).astype(np.int32)
    counts = rng.integers(0, m + 1, C).astype(np.int32)
    counts[0] = 0                                    # an empty class
    want = jops.ring_window(jnp.asarray(store), jnp.asarray(front),
                            jnp.asarray(counts), m=m)
    got = ops.ring_window(torch.from_numpy(store), torch.from_numpy(front),
                          torch.from_numpy(counts), m=m)
    _eq(got, want, "ring_window")
    with pytest.raises(ValueError):
        ops.ring_window(torch.from_numpy(store), torch.from_numpy(front),
                        torch.from_numpy(counts), m=cap + 1)


def test_ring_window_wraparound():
    got = ops.ring_window(torch.arange(32, dtype=torch.int32)[None],
                          torch.tensor([30], dtype=torch.int32),
                          torch.tensor([5], dtype=torch.int32), m=8)
    assert got[0].tolist() == [30, 31, 0, 1, 2, -1, -1, -1]


@pytest.mark.parametrize("w", [32, 64, 256])
@pytest.mark.parametrize("k", [0, 1, 7, 100, 10 ** 6])
def test_bitmap_select_matches_reference(w, k):
    rng = np.random.default_rng(w + k)
    words = rng.integers(0, 2 ** 32, w, dtype=np.uint64).astype(np.uint32)
    want = jops.bitmap_select(jnp.asarray(words), k)
    got = ops.bitmap_select(torch.from_numpy(words.view(np.int32)), k)
    _eq(got, want, "bitmap_select")


def test_bitmap_select_raises_on_partial_block():
    with pytest.raises(ValueError):
        ops.bitmap_select(torch.zeros(33, dtype=torch.int32), 1)


@pytest.mark.parametrize("words,k,max_k", [
    ([0b1011, 0, 1] + [0] * 29, 3, 4),
    (None, 50, 64), (None, 0, 8), (None, 10 ** 6, 40 * 32)],
    ids=("reference-case", "random", "k-0", "max-k-past-the-bits"))
def test_bitmap_select_indices_matches_reference(words, k, max_k):
    if words is None:
        words = np.random.default_rng(k).integers(
            0, 2 ** 32, 64, dtype=np.uint64)
    words = np.asarray(words, np.uint64).astype(np.uint32)
    wi, wv = jops.bitmap_select_indices(jnp.asarray(words), k, max_k=max_k)
    gi, gv = ops.bitmap_select_indices(torch.from_numpy(words.view(np.int32)),
                                       k, max_k=max_k)
    _eq(gi, wi, "indices")
    assert gv.numpy().tolist() == np.asarray(wv).tolist()


def _ring_lanes(rng, C, cap, n, base, out_of_range):
    store = rng.integers(0, 10 ** 6, (C, cap)).astype(np.int32)
    front = (base + rng.integers(0, 100, C)).astype(np.int32)
    back = (front.astype(np.int64) + rng.integers(0, cap + 1, C)
            ).astype(np.int32)
    lo, hi = (-1, C + 1) if out_of_range else (0, C)
    cls = rng.integers(lo, hi, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    if not out_of_range:
        mask &= cls < C
    return store, front, back, cls, mask


RING_CASES = [(5, 48, 33, 0, False), (5, 48, 33, 0, True),
              (3, 64, 40, -2 ** 31 + 9, True), (1, 16, 7, 0, False)]
RING_IDS = ("reference-case", "out-of-range-classes", "wrapped", "one-class")


@pytest.mark.parametrize("limit", (True, False), ids=("limit", "pool"))
@pytest.mark.parametrize("C,cap,n,base,oor", RING_CASES, ids=RING_IDS)
def test_ring_txn_pop_matches_reference(C, cap, n, base, oor, limit):
    store, front, back, cls, mask = _ring_lanes(
        np.random.default_rng(n + C), C, cap, n, base, oor)
    wv, wf = jops.ring_txn_pop(*map(jnp.asarray, (store, front, back, cls,
                                                  mask)), limit=limit)
    gv, gf = ops.ring_txn_pop(*map(torch.from_numpy, (store, front, back,
                                                      cls, mask)),
                              limit=limit)
    _eq(gv, wv, "vals")
    _eq(gf, wf, "front")


@pytest.mark.parametrize("C,cap,n,base,oor", RING_CASES, ids=RING_IDS)
def test_ring_txn_push_matches_reference(C, cap, n, base, oor):
    rng = np.random.default_rng(2 * n + C)
    store, _, back, cls, mask = _ring_lanes(rng, C, cap, n, base, oor)
    vals = rng.integers(0, 10 ** 6, n).astype(np.int32)
    ws, wb = jops.ring_txn_push(*map(jnp.asarray, (store, back, cls, vals,
                                                   mask)))
    st = torch.from_numpy(store.copy())
    gs, gb = ops.ring_txn_push(st, *map(torch.from_numpy,
                                        (back, cls, vals, mask)))
    assert gs is st                                   # in place
    _eq(gs, ws, "store")
    _eq(gb, wb, "back")


@pytest.mark.parametrize("ppc,bw", [(32, 1), (128, 4), (16, 1)])
def test_chunk_txn_claim_matches_reference(ppc, bw):
    rng = np.random.default_rng(ppc)
    for take in (0, 3, 10 ** 4):
        row = rng.integers(0, 2 ** 32, bw, dtype=np.uint64).astype(np.uint32)
        wi, wr, wn = jops.chunk_txn_claim(jnp.asarray(row), jnp.int32(take),
                                          ppc=ppc)
        gi, gr, gn = ops.chunk_txn_claim(torch.from_numpy(row.view(np.int32)),
                                         take, ppc=ppc)
        _eq(gi, wi, f"page_idx, take {take}")
        _eq(gr, wr, f"row, take {take}")
        _eq(gn, wn, f"count, take {take}")


# ---- six-variant traces: port (both routes) vs reference (both backends) ----

@functools.lru_cache(maxsize=None)
def _jfns(kind, family, backend):
    """The reference's alloc/free for one variant and backend, jitted
    once per test process (fixed lane width: one compile each)."""
    jmod = MODS[kind][0]
    cfg = JHeapConfig(**CFG)
    return (jax.jit(functools.partial(jmod.alloc, cfg, family,
                                      backend=backend)),
            jax.jit(functools.partial(jmod.free, cfg, family,
                                      backend=backend)))


def _port_state(kind, family, piecewise):
    cfg = HeapConfig(**CFG)
    lay = arena.layout(cfg, kind, family)
    q, ctx, meta = arena.unpack(lay, arena.blank(lay, "cpu"))
    st = page_alloc.AllocState(q, ctx, meta)
    MODS[kind][1].init(cfg, family, st, piecewise=piecewise)
    return st


def _same_state(jst, st, what):
    """Every view of the port's state equals the reference's field."""
    pairs = list(zip(jst.q, st.q)) + [(jst.ctx.heap, st.ctx.heap)] \
        + list(zip(jst.ctx.pool, st.ctx.pool))
    if jst.meta is not None:
        pairs += list(zip(jst.meta, st.meta))
    for i, (want, got) in enumerate(pairs):
        assert tuple(got.shape) == np.asarray(want).shape, (what, i)
        _eq(got, _words(want), f"{what}: state field {i}")


def _trace(kind, family, n_ops, seed):
    """Run one seeded alloc/free trace through the reference (pallas and
    jnp backends) and the port (piecewise and plain) in lockstep,
    comparing after every transaction.  Returns the four states."""
    cfg = HeapConfig(**CFG)
    jmod, mod = MODS[kind]
    jcfg = JHeapConfig(**CFG)
    jst = {b: jmod.init(jcfg, family) for b in ("pallas", "jnp")}
    st = {pw: _port_state(kind, family, pw) for pw in (True, False)}
    for pw in st:
        _same_state(jst["jnp"], st[pw], f"init, piecewise={pw}")
    rng = np.random.default_rng(seed)
    live, served = [], 0
    for step in range(n_ops):
        if live and step % 3 == 2:
            k = min(len(live), int(rng.integers(1, LANES + 1)))
            pick = set(rng.choice(len(live), k, replace=False).tolist())
            drop = [x for i, x in enumerate(live) if i in pick]
            live = [x for i, x in enumerate(live) if i not in pick]
            fo = np.full(LANES, -1, np.int32)
            fs = np.zeros(LANES, np.int32)
            fo[:k] = [o for o, _ in drop]
            fs[:k] = [s for _, s in drop]
            perm = rng.permutation(LANES)
            fo, fs = fo[perm], fs[perm]
            fm = (fo >= 0) & (rng.random(LANES) < 0.95)
            live += [(o, s) for o, s, m in zip(fo, fs, fm) if o >= 0 and not m]
            for b in jst:
                jst[b] = _jfns(kind, family, b)[1](
                    jst[b], jnp.asarray(fo), jnp.asarray(fs), jnp.asarray(fm))
            for pw in st:
                mod.free(cfg, family, st[pw], torch.from_numpy(fo),
                         torch.from_numpy(fs), torch.from_numpy(fm),
                         piecewise=pw)
            what = f"free {step}"
        else:
            sizes = rng.choice(MENU, LANES).astype(np.int32)
            mask = rng.random(LANES) < 0.9
            outs = {}
            for b in jst:
                jst[b], o = _jfns(kind, family, b)[0](
                    jst[b], jnp.asarray(sizes), jnp.asarray(mask))
                outs[b] = np.asarray(o)
            np.testing.assert_array_equal(outs["pallas"], outs["jnp"])
            for pw in st:
                _, o = mod.alloc(cfg, family, st[pw], torch.from_numpy(sizes),
                                 torch.from_numpy(mask), piecewise=pw)
                _eq(o, outs["jnp"], f"alloc {step} offsets, piecewise={pw}")
            live += [(int(o), int(s)) for o, s in zip(outs["jnp"], sizes)
                     if o >= 0]
            served += int((outs["jnp"] >= 0).sum())
            what = f"alloc {step}"
        for pw in st:
            for b in jst:
                _same_state(jst[b], st[pw], f"{what}, piecewise={pw}, {b}")
    assert served > 0 and live
    return jst, st


@pytest.mark.parametrize("kind,family", VARIANTS, ids=VIDS)
def test_piecewise_trace_matches_reference(kind, family):
    """Alloc/free traces over mixed size classes (over-large and masked
    lanes included, frees in shuffled lanes with some masked): offsets
    and every state view equal after every transaction, for the port
    with and without ``piecewise`` against the reference with
    ``backend="pallas"`` and ``"jnp"``."""
    _trace(kind, family, n_ops=10, seed=VARIANTS.index((kind, family)))


@pytest.mark.parametrize("family", ("ring", "va", "vl"))
def test_compact_matches_reference(family):
    """``compact`` after a trace returns the same fully free chunks to
    the pool and rebuilds the same queues as the reference's, on both
    routes; an alloc and a free after it stay in step."""
    jst, st = _trace("chunk", family, n_ops=8, seed=11)
    jcfg, cfg = JHeapConfig(**CFG), HeapConfig(**CFG)
    for b in jst:
        jst[b] = jchunk.compact(jcfg, family, jst[b])
    for pw in st:
        chunk_alloc.compact(cfg, family, st[pw], piecewise=pw)
        for b in jst:
            _same_state(jst[b], st[pw], f"compact, piecewise={pw}, {b}")
    unbound = (np.asarray(jst["jnp"].meta.chunk_class) < 0).sum()
    assert int(unbound) > 0
    sizes = np.full(LANES, 64, np.int32)
    mask = np.ones(LANES, bool)
    for b in jst:
        jst[b], want = _jfns("chunk", family, b)[0](
            jst[b], jnp.asarray(sizes), jnp.asarray(mask))
    for pw in st:
        _, got = chunk_alloc.alloc(cfg, family, st[pw],
                                   torch.from_numpy(sizes),
                                   torch.from_numpy(mask), piecewise=pw)
        _eq(got, want, f"alloc after compact, piecewise={pw}")
    fm = np.asarray(want) >= 0
    for b in jst:
        jst[b] = _jfns("chunk", family, b)[1](
            jst[b], want, jnp.asarray(sizes), jnp.asarray(fm))
    for pw in st:
        chunk_alloc.free(cfg, family, st[pw], torch.from_numpy(np.array(want)),
                         torch.from_numpy(sizes), torch.from_numpy(fm),
                         piecewise=pw)
        for b in jst:
            _same_state(jst[b], st[pw], f"free after compact, {pw}, {b}")


def test_ring_page_alloc_window_is_the_grant():
    """The page allocator's grants are rank-dense ring windows: on a
    fresh ``ring`` page arena, each granted lane's offset is the class
    window's entry at its rank (the reference's kernel/core check)."""
    from repro_torch.core import groups
    from repro_torch.core.heap import size_to_class_device
    cfg = HeapConfig(**CFG)
    st = _port_state("page", "ring", True)
    sizes = torch.from_numpy(
        np.random.default_rng(0).choice([16, 64, 256], 32).astype(np.int32))
    cls = size_to_class_device(cfg, sizes)
    valid = cls < cfg.num_classes
    rank, counts = groups.masked_rank(cls, valid, cfg.num_classes)
    win = ops.ring_window(st.q.store, st.q.front, torch.clamp(counts, max=32),
                          m=32)
    _, offs = page_alloc.alloc(cfg, "ring", st, sizes, valid, piecewise=True)
    ok = offs >= 0
    assert bool(ok.all())
    assert torch.equal(win[cls.long(), rank.long()], offs)


# ---- nothing but the piecewise route reaches the five steps ---------------

STEPS = ("ring_txn_pop", "ring_txn_push", "chunk_txn_claim", "ring_window",
         "bitmap_select", "bitmap_select_indices")


@pytest.fixture()
def steps_raise(monkeypatch):
    def boom(name):
        def f(*a, **k):
            raise AssertionError(f"{name} reached off the piecewise route")
        return f
    for name in STEPS:
        monkeypatch.setattr(ops, name, boom(name))


def test_piecewise_route_reaches_the_steps(steps_raise):
    """Control: with the steps made to raise, the piecewise route does
    raise, for a page and a chunk variant."""
    cfg = HeapConfig(**CFG)
    for kind, family in (("page", "ring"), ("chunk", "va")):
        st = _port_state(kind, family, False)
        with pytest.raises(AssertionError, match="piecewise route"):
            MODS[kind][1].alloc(cfg, family, st,
                                torch.full((LANES,), 64, dtype=torch.int32),
                                torch.ones(LANES, dtype=torch.bool),
                                piecewise=True)


def test_transactions_and_engine_never_reach_the_steps(steps_raise):
    """With the five steps made to raise: the transaction math, a
    defragmentation wave, a sharded transaction with its wave and
    rebalance, and a short serving run all complete."""
    from repro_torch.configs import get_arch
    from repro_torch.models import params as P
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = HeapConfig(total_bytes=1 << 15, chunk_bytes=1 << 11,
                     min_page_bytes=64)
    rng = np.random.default_rng(1)
    o = Ouroboros(cfg, "vl_chunk", device="cpu")
    st = o.init()
    live = []
    for _ in range(6):
        sizes = torch.full((16,), 64, dtype=torch.int32)
        _, _, offs = transactions.alloc_math(cfg, "chunk", "vl", st.mem,
                                             st.ctl, sizes,
                                             torch.ones(16, dtype=torch.bool))
        live += [x for x in offs.tolist() if x >= 0]
    drop = torch.tensor([x for i, x in enumerate(live) if i % 3],
                        dtype=torch.int32)
    transactions.free_math(cfg, "chunk", "vl", st.mem, st.ctl, drop,
                           torch.full_like(drop, 64),
                           torch.ones_like(drop, dtype=torch.bool))
    st, fwd = o.defrag(st)
    assert int((fwd.src >= 0).sum()) > 0

    sh = Ouroboros(HeapConfig(total_bytes=4 * 12 * 4096, chunk_bytes=4096,
                              min_page_bytes=256), "vl_chunk", device="cpu",
                   num_shards=4)
    ss = sh.init()
    sizes = torch.full((16,), 256, dtype=torch.int32)
    for _ in range(4):
        ss, offs = sh.alloc(ss, sizes, torch.from_numpy(rng.random(16) < 0.9),
                            shard_hint=np.zeros(16, np.int32))
    ss = sh.free(ss, offs, sizes, offs >= 0)
    ss, _ = sh.defrag(ss)
    ss, _ = sh.rebalance(ss)

    mcfg = get_arch("qwen2-0.5b").smoke()
    eng = ServingEngine(build_model(mcfg), P.init(mcfg, 0), max_batch=2,
                        max_seq=64, kv_dtype=torch.float32,
                        compute_dtype=torch.float32, defrag_threshold=0.5,
                        device="cpu")
    for n in (5, 9, 3):
        eng.submit(list(range(1, n + 1)), 3)
    done = eng.run_until_done()
    assert len(done) == 3 and eng.stats["allocs"] == eng.stats["frees"]
