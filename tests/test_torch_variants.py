"""The port's six allocator variants held to the JAX reference.

The paper's six variants (``page``, ``chunk``, ``va_page``, ``vl_page``,
``va_chunk``, ``vl_chunk``) run the same seeded alloc/free traces
through ``repro.core.Ouroboros(..., backend="jnp")`` and the port's
``repro_torch.core.Ouroboros(..., device="cpu")`` (the plain math of the
fused CUDA transactions); ``mem``, ``ctl`` and the granted offsets must
be identical after every transaction.  The traces cover mixed classes,
segment churn with tiny chunks, heap exhaustion, ring and segment wrap,
counters carried past 2^31, and sharded arenas of 2 and 4 shards.  One
case per variant runs the reference's fused Pallas kernel
(``lowering="whole"``, interpret mode).  Then the chunk variants'
defragmentation plans and waves and the rebalance, the page kinds'
``frag_stats`` and no-op waves, ``compact`` and the paper's
``write_pattern``/``check_pattern`` data path.  Every comparison is
exact.  Lane widths stay fixed and one reference facade serves each
(config, variant), so the reference compiles few shapes.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import HeapConfig as JHeap, Ouroboros as JOuro
from repro.core import arena as jarena

from repro_torch.core import VARIANTS, HeapConfig, Ouroboros, arena
from repro_torch.obs import telemetry

CFG = dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16)
GROW_CFG = dict(total_bytes=1 << 16, chunk_bytes=64, min_page_bytes=16)
TINY_CFG = dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16)
# the reference's wraparound heap (tests/test_exhaustion.py WRAP_CFG)
WRAP_CFG = dict(total_bytes=1 << 14, chunk_bytes=256, min_page_bytes=64)
# 64 chunks of 1 KiB, 7 classes: 16 chunks a shard at 4 shards, so a
# shard holds data chunks beside one queue segment per class
SHARD_CFG = dict(total_bytes=1 << 16, chunk_bytes=1 << 10, min_page_bytes=16)
SHARD_SIZES = [16, 256, 1000, 1000, 1000, 2048]  # 2048 > chunk: fails
SIZES = [16, 24, 100, 256, 1000, 2048, 8192]   # 8192 > chunk: fails
GROW_SIZES = [16, 32, 64, 128]                  # 128 > chunk: fails
N = 16
CHUNK_VARIANTS = ("chunk", "va_chunk", "vl_chunk")
PAGE_VARIANTS = ("page", "va_page", "vl_page")


@functools.lru_cache(maxsize=None)
def _jouro(cfgkey, variant, backend="jnp", lowering="auto", num_shards=1):
    return JOuro(JHeap(**dict(cfgkey)), variant, backend=backend,
                 lowering=lowering, num_shards=num_shards)


def _pair(cfgkw, variant, num_shards=1, **kw):
    return (_jouro(tuple(sorted(cfgkw.items())), variant,
                   num_shards=num_shards, **kw),
            Ouroboros(HeapConfig(**cfgkw), variant, device="cpu",
                      num_shards=num_shards))


def _same(js, ts, what):
    for name in ("mem", "ctl"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        diff = np.argwhere(a != b)
        assert diff.size == 0, f"{what}: {name} differs at {diff[:8]}"


def _to_jax(st):
    """The port's arena as a reference arena of its own words: a copy,
    since the reference donates its state to each transaction and a
    buffer shared with the port's tensors would be written by both."""
    return jarena.Arena(mem=jnp.array(st.mem.numpy(), copy=True),
                        ctl=jnp.array(st.ctl.numpy(), copy=True))


class Lockstep:
    """One reference facade and one port facade driven by the same
    transactions; every step holds both arenas and the offsets equal."""

    def __init__(self, cfgkw, variant, num_shards=1, **kw):
        self.oj, self.ot = _pair(cfgkw, variant, num_shards, **kw)
        # one compiled program: the reference's init runs op by op
        # otherwise, seconds for each page-kind heap
        self.sj = jax.jit(self.oj.init)()
        self.st = self.ot.init()
        _same(self.sj, self.st, "init")
        self.live, self.failed, self.step = [], 0, 0

    def alloc(self, sizes, mask, hint=None):
        kw = {} if hint is None else {"shard_hint": hint}
        self.sj, oj = self.oj.alloc(
            self.sj, jnp.asarray(sizes), jnp.asarray(mask),
            **({} if hint is None else
               {"shard_hint": jnp.asarray(hint)}))
        self.st, ot = self.ot.alloc(self.st, torch.from_numpy(sizes),
                                    torch.from_numpy(mask), **kw)
        np.testing.assert_array_equal(np.asarray(oj), ot.numpy(),
                                      err_msg=f"offsets at {self.step}")
        self.failed += int(((ot < 0) & torch.from_numpy(mask)).sum())
        self.live += [(int(o), int(s)) for o, s in
                      zip(ot.tolist(), sizes.tolist()) if o >= 0]
        self._check("alloc")
        return ot

    def free(self, fo, fs):
        fm = fo >= 0
        self.sj = self.oj.free(self.sj, jnp.asarray(fo),
                               jnp.asarray(fs), jnp.asarray(fm))
        self.st = self.ot.free(self.st, torch.from_numpy(fo),
                               torch.from_numpy(fs), torch.from_numpy(fm))
        self._check("free")

    def free_some(self, rng, k):
        k = min(len(self.live), k)
        pick = set(rng.choice(len(self.live), k, replace=False).tolist())
        drop = [x for i, x in enumerate(self.live) if i in pick]
        self.live = [x for i, x in enumerate(self.live) if i not in pick]
        fo = np.full(N, -1, np.int32)
        fs = np.zeros(N, np.int32)
        fo[:k] = [o for o, _ in drop]
        fs[:k] = [s for _, s in drop]
        perm = rng.permutation(N)          # holes anywhere in the lanes
        self.free(fo[perm].copy(), fs[perm].copy())

    def _check(self, what):
        _same(self.sj, self.st, f"{what} {self.step}")
        self.step += 1

    def trace(self, menu, seed, n_ops, bias_alloc=0.6, pmask=0.85,
              hints=None):
        rng = np.random.default_rng(seed)
        for i in range(n_ops):
            if not self.live or rng.random() < bias_alloc:
                hint = None if hints is None else hints(rng, i)
                self.alloc(rng.choice(menu, N).astype(np.int32),
                           rng.random(N) < pmask, hint)
            else:
                self.free_some(rng, int(rng.integers(1, N + 1)))
        return self

    def tele(self):
        return telemetry.decode(arena.layout(self.ot.shard_cfg,
                                             self.ot.kind, self.ot.family),
                                self.st.ctl)


# ---- single-arena traces -----------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_mixed_classes_trace(variant):
    ls = Lockstep(CFG, variant).trace(SIZES, 0, 8)
    assert int(ls.tele()["t_alloc"].sum()) > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_segment_churn_trace(variant):
    """64-B chunks: a va segment holds 16 slots, a vl segment 15, so the
    trace grows and shrinks the virtualized queues through the pool."""
    ls = Lockstep(GROW_CFG, variant).trace(GROW_SIZES, 4, 24)
    if not variant.startswith(("page", "chunk")):
        assert ls.tele()["t_shrink"] > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_exhaustion_trace(variant):
    """A heap far too small for the traffic: failed lanes, and for the
    virtualized queues segment pops past the pool's inventory."""
    ls = Lockstep(TINY_CFG, variant).trace([16, 32, 64], 5, 24,
                                           bias_alloc=0.8)
    assert ls.failed > 0
    assert int(ls.tele()["t_fail"].sum()) == ls.failed


@pytest.mark.parametrize("variant", VARIANTS)
def test_wraparound_trace(variant):
    """The reference's wraparound cycles (13 of 16 lanes of 64 B, then
    free them all): page ring positions wrap the ring capacity, the
    virtualized page queues cross segment boundaries."""
    ls = Lockstep(WRAP_CFG, variant)
    sizes = np.full(N, 64, np.int32)
    for _ in range(6):
        offs = ls.alloc(sizes, np.arange(N) < 13).numpy()
        ls.free(np.where(offs >= 0, offs, -1).astype(np.int32), sizes)
    front0 = int(ls.st.ctl[0])
    if variant == "page":
        assert front0 > ls.ot.layout.queue_capacity
    if variant in ("va_page", "vl_page"):
        assert front0 > HeapConfig(**WRAP_CFG).slots_per_segment(
            ls.ot.family)


def _shift_counters(st, lay, past):
    """Move each class queue's counters, and the pool's, by the amount
    that leaves its back ``past`` slots below 2^31 (its count kept).  A
    ring's store rows are rotated with them, so ring queues still hold
    the same items; a virtualized queue's slots move within and across
    its segments, which both sides read alike."""
    C, cfg = lay.num_classes, lay.cfg
    ctl = st.ctl.to(torch.int64)
    d = 2 ** 31 - past - ctl[lay.off_back:lay.off_back + C]
    ctl[lay.off_front:lay.off_front + C] += d
    ctl[lay.off_back:lay.off_back + C] += d
    dp = 2 ** 31 - past - int(ctl[lay.off_pool_back])
    ctl[lay.off_pool_front:lay.off_pool_back + 1] += dp
    st.ctl.copy_(ctl.to(torch.int32))
    if lay.family == "ring":
        r = lay.region("queue_store")
        rows = st.mem[r.offset:r.end].view(r.shape)
        for c in range(C):
            rows[c] = torch.roll(rows[c], int(d[c]) % r.shape[1])
    ps = st.mem[lay.region("pool_store").offset:][:cfg.num_chunks]
    ps.copy_(torch.roll(ps, dp % cfg.num_chunks))


@pytest.mark.parametrize("variant", VARIANTS)
def test_counters_past_2_31_trace(variant):
    """Queue and pool counters carried to 3 slots below 2^31, then a
    churn trace takes them past it: the 32-bit wrap of ``front + rank``
    and of the counters, where the ring capacity (384 for ``page``)
    does not divide 2^32."""
    ls = Lockstep(CFG, variant)
    _shift_counters(ls.st, ls.ot.layout, 3)
    ls.sj = _to_jax(ls.st)
    ls.trace([16, 16, 32, 64], 8, 8, bias_alloc=0.7)
    core = ls.st.ctl[:ls.ot.layout.core_ctl_words]
    assert int(core.min()) < 0                     # a counter wrapped


def test_page_ring_grant_is_the_inventory_prefix():
    """A page-ring alloc past its class inventory grants exactly the
    rank prefix that fits, in lane order."""
    ls = Lockstep(WRAP_CFG, "page")
    inv = int(ls.st.ctl[ls.ot.layout.off_back])     # class 0's pages
    sizes = np.full(N, 64, np.int32)
    got = 0
    while got <= inv:
        offs = ls.alloc(sizes, np.ones(N, bool)).numpy()
        ok = offs >= 0
        assert not ok.any() or ok[:ok.sum()].all()
        got += int(ok.sum())
        if not ok.all():
            break
    assert got == inv


# ---- the reference's fused Pallas kernel ------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_trace_matches_reference_pallas_kernel(variant):
    """The reference's fused transaction (whole lowering, interpret
    mode) is held to the same words."""
    Lockstep(CFG, variant, backend="pallas", lowering="whole").trace(
        SIZES, 2, 4)


# ---- sharded arenas -------------------------------------------------------------

@pytest.mark.parametrize("S", (2, 4))
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_trace(variant, S):
    """Hashed homes, every lane pinned to shard 0, and per-lane hints
    (some out of range): lanes overflow to neighbour shards (walk
    attempts > 0) and every free goes to the shard that owns it."""
    def hints(rng, i):
        return (None, np.zeros(N, np.int32), np.zeros(N, np.int32),
                rng.integers(-2, 2 * S, N).astype(np.int32))[i % 4]

    ls = Lockstep(SHARD_CFG, variant, num_shards=S).trace(
        SHARD_SIZES, 3, 8, bias_alloc=0.8, hints=hints)
    walk = ls.tele()["t_walk"].sum(0)
    assert int(walk[1:].sum()) > 0


# ---- defragmentation, frag stats, compact, the data path -------------------

def _strand(ls, seed, n_ops=20):
    """Churn then free two of every three live grants: many sparse
    chunks for a wave to compact."""
    rng = np.random.default_rng(seed)
    ls.trace([16, 16, 64, 256], seed, n_ops, bias_alloc=0.85)
    drop = [x for i, x in enumerate(ls.live) if i % 3]
    ls.live = [x for i, x in enumerate(ls.live) if not i % 3]
    rng.shuffle(drop)
    for i in range(0, len(drop), N):
        part = drop[i:i + N]
        fo = np.full(N, -1, np.int32)
        fs = np.zeros(N, np.int32)
        fo[:len(part)] = [o for o, _ in part]
        fs[:len(part)] = [s for _, s in part]
        ls.free(fo, fs)
    return ls


def _wave(ls, what, max_moves=None):
    kw = {} if max_moves is None else {"max_moves": max_moves}
    ls.sj, fj = getattr(ls.oj, what)(ls.sj, **kw)
    ls.st, ft = getattr(ls.ot, what)(ls.st, **kw)
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ls._check(what)
    return int((ft.src >= 0).sum())


@pytest.mark.parametrize("variant", ("chunk", "va_chunk"))
def test_defrag_waves(variant):
    """Plans and waves of the ring and va rebuilds on 64-B chunks (a va
    rebuild grows its queues by whole 16-slot segments), then more
    traffic on the rebuilt queues; a truncated wave as well."""
    ls = _strand(Lockstep(GROW_CFG, variant), 3)
    moved = _wave(ls, "defrag", max_moves=4) + _wave(ls, "defrag")
    assert moved > 0
    ls.trace([16, 64], 9, 6)
    _wave(ls, "defrag")


@pytest.mark.parametrize("variant", ("chunk", "va_chunk"))
def test_sharded_defrag_and_rebalance(variant):
    """Every lane homed on shard 0, then a sharded compaction wave and a
    cross-shard rebalance wave; the ring and va rebuilds of every
    shard."""
    ls = Lockstep(SHARD_CFG, variant, num_shards=4)
    ls.trace([16, 16, 64, 256], 6, 14, bias_alloc=0.85,
             hints=lambda rng, i: np.zeros(N, np.int32))
    ls.free_some(np.random.default_rng(1), N)
    _wave(ls, "defrag")
    assert _wave(ls, "rebalance") > 0
    ls.trace([16, 64], 2, 6)


@pytest.mark.parametrize("variant", PAGE_VARIANTS)
def test_page_kinds_frag_stats_and_noop_waves(variant):
    """Page kinds: free words are the queued pages times their words,
    the largest extent the largest class still queued; a defrag wave
    moves nothing and leaves every word, single and sharded."""
    for S in (1, 2):
        ls = Lockstep(CFG if S == 1 else SHARD_CFG, variant,
                      num_shards=S).trace(SIZES, 7, 8)
        fj = ls.oj.frag_stats(ls.sj)
        ft = ls.ot.frag_stats(ls.st)
        for k in ("free_words", "largest_free_extent", "frag_ratio"):
            np.testing.assert_array_equal(np.asarray(fj[k]),
                                          np.asarray(ft[k]))
        before = (ls.st.mem.clone(), ls.st.ctl.clone())
        assert _wave(ls, "defrag") == 0
        if S > 1:
            assert _wave(ls, "rebalance") == 0
        assert torch.equal(before[0], ls.st.mem)
        assert torch.equal(before[1], ls.st.ctl)


@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_chunk_frag_stats_after_waves(variant):
    ls = _strand(Lockstep(CFG, variant), 4)
    _wave(ls, "defrag")
    fj = ls.oj.frag_stats(ls.sj)
    ft = ls.ot.frag_stats(ls.st)
    assert ft["free_words"] == int(fj["free_words"])
    assert ft["largest_free_extent"] == int(fj["largest_free_extent"])


@pytest.mark.parametrize("S", (1, 2))
@pytest.mark.parametrize("variant", VARIANTS)
def test_compact(variant, S):
    """``compact`` after churn (a no-op for page kinds), then traffic on
    the rebuilt queues."""
    ls = _strand(Lockstep(CFG if S == 1 else SHARD_CFG, variant,
                          num_shards=S), 5, 16)
    before = ls.st.mem.clone()
    ls.sj = jax.jit(ls.oj.compact)(ls.sj)   # one program, not op by op
    ls.st = ls.ot.compact(ls.st)
    ls._check("compact")
    if variant in PAGE_VARIANTS:
        assert torch.equal(before, ls.st.mem)
    ls.trace([16, 256], 6, 4)


@pytest.mark.parametrize("S", (1, 2))
@pytest.mark.parametrize("variant", VARIANTS)
def test_write_and_check_pattern(variant, S):
    """The paper's data path: tags written over every grant read back
    on both sides, the heaps identical; an overlapping write breaks
    exactly the lanes it overlaps."""
    ls = Lockstep(CFG if S == 1 else SHARD_CFG, variant, num_shards=S)
    rng = np.random.default_rng(11)
    sizes = rng.choice([16, 64, 256, 1000, 8192], N).astype(np.int32)
    offs = ls.alloc(sizes, np.ones(N, bool))
    tag = np.arange(1, N + 1, dtype=np.int32) * 7919
    ls.sj = ls.oj.write_pattern(ls.sj, jnp.asarray(offs.numpy()),
                                jnp.asarray(sizes), jnp.asarray(tag))
    ls.st = ls.ot.write_pattern(ls.st, offs, torch.from_numpy(sizes),
                                torch.from_numpy(tag))
    ls._check("write_pattern")
    np.testing.assert_array_equal(np.asarray(ls.oj.heap(ls.sj)),
                                  ls.ot.heap(ls.st).numpy())
    okj = np.asarray(ls.oj.check_pattern(
        ls.sj, jnp.asarray(offs.numpy()), jnp.asarray(sizes),
        jnp.asarray(tag)))
    okt = ls.ot.check_pattern(ls.st, offs, torch.from_numpy(sizes),
                              torch.from_numpy(tag)).numpy()
    np.testing.assert_array_equal(okj, okt)
    np.testing.assert_array_equal(okt, offs.numpy() >= 0)
    assert okt.any()
    # one word written over another grant's first word breaks that one
    i, j = np.nonzero(okt)[0][:2]
    bad = offs.clone()
    bad[j] = offs[i]
    tag2, sizes2 = tag.copy(), sizes.copy()
    tag2[j], sizes2[j] = -5, 4
    ls.st = ls.ot.write_pattern(ls.st, bad, torch.from_numpy(sizes2),
                                torch.from_numpy(tag2))
    again = ls.ot.check_pattern(ls.st, offs, torch.from_numpy(sizes),
                                torch.from_numpy(tag)).numpy()
    assert not again[i] and again.sum() == okt.sum() - 1
