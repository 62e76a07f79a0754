"""The port's sharded allocator and the serving engine's ``num_shards`` /
``rebalance_threshold`` paths, held to the JAX reference.

The same numpy-seeded traces run through the reference
(``repro.core.Ouroboros(cfg, "vl_chunk", num_shards=S)``, jnp backend)
and the port (``device="cpu"``, where ``sharded_alloc_txn``,
``sharded_free_txn`` and ``sharded_defrag_txn`` run their plain
versions, the serial replays of ``core/transactions.py`` and
``core/defrag.py``).  Offsets, forwarding tables and every ``mem`` /
``ctl`` word (telemetry included) must be identical; the engines must
give the same tokens per uid and the same stats.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.core import HeapConfig as JHeap, Ouroboros as JOuro
from repro.core import shards as jshards
from repro.models.model import build_model as jbuild
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.core import HeapConfig, Ouroboros, arena, shards
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServingEngine

GOLDEN = pathlib.Path(__file__).parent / "golden" / "shard_layout.txt"
S = 4
# the engine's page geometry at 4 shards x 12 chunks
# (make_kv_allocator(256, num_shards=4))
KV = dict(total_bytes=4 * 12 * 4096, chunk_bytes=4096, min_page_bytes=256)
N = 16


def _same(js, ts, what):
    for name in ("mem", "ctl"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        diff = np.argwhere(a != b)
        assert diff.size == 0, f"{what}: {name} differs at {diff[:8]}"


def test_shard_layout_matches_golden_byte_for_byte():
    """All six variants render ``tests/golden/shard_layout.txt`` (the
    reference's fingerprint input), and each ``blocks=False`` rendering
    equals the reference's."""
    cfg = HeapConfig(total_bytes=1 << 16, chunk_bytes=1 << 11,
                     min_page_bytes=16)
    jcfg = JHeap(total_bytes=1 << 16, chunk_bytes=1 << 11,
                 min_page_bytes=16)
    got = "\n".join(shards.layout(cfg, S, k, f).describe(blocks=True)
                    for k in arena.KINDS
                    for f in arena.QUEUE_FAMILIES) + "\n"
    assert got == GOLDEN.read_text()
    for k in arena.KINDS:
        for f in arena.QUEUE_FAMILIES:
            slay = shards.layout(cfg, S, k, f)
            jlay = jshards.layout(jcfg, S, k, f)
            assert slay.describe() == jlay.describe()
            assert (slay.shard_words, slay.mem_words, slay.ctl_words) == \
                (jlay.shard_words, jlay.mem_words, jlay.ctl_words)
            assert slay.shard is arena.layout(shards.shard_config(cfg, S),
                                              k, f)


@pytest.mark.parametrize("n", (1, 16, 4096))
@pytest.mark.parametrize("hint", ("none", "int", "numpy-int", "array"))
def test_home_shards_match_reference(n, hint):
    """Hashed homes in uint32 arithmetic (the product overflows 32 bits
    from lane 2 on), pinned ints (negative ones wrap by floor modulo),
    and per-lane arrays with negative and out-of-range hints."""
    rng = np.random.default_rng(n)
    h = {"none": None, "int": 6, "numpy-int": np.int64(-3),
         "array": rng.integers(-9, 9, n).astype(np.int32)}[hint]
    jh = jnp.asarray(h) if hint == "array" else h
    want = np.asarray(jshards.home_shards(n, S, jh))
    got = shards.home_shards(n, S, h)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _pair(walk=None, cfgkw=KV):
    return (JOuro(JHeap(**cfgkw), "vl_chunk", num_shards=S,
                  overflow_walk=walk),
            Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device="cpu",
                      num_shards=S, overflow_walk=walk))


def _trace(oj, ot, seed, ops_, hint_of, free_hint=None):
    """Alloc/free in lockstep on both packages: offsets and words equal
    after every transaction.  ``hint_of(rng, step)`` gives the alloc's
    ``shard_hint``.  Returns the two states."""
    sj, st = oj.init(), ot.init()
    _same(sj, st, "init")
    rng = np.random.default_rng(seed)
    live = []
    for step in range(ops_):
        if live and step % 4 == 3:
            k = min(len(live), int(rng.integers(1, N + 1)))
            pick = set(rng.choice(len(live), k, replace=False).tolist())
            drop = [x for i, x in enumerate(live) if i in pick]
            live = [x for i, x in enumerate(live) if i not in pick]
            fo = np.full(N, -1, np.int32)
            fs = np.zeros(N, np.int32)
            fo[:k] = [a for a, _ in drop]
            fs[:k] = [b for _, b in drop]
            perm = rng.permutation(N)
            fo, fs = fo[perm], fs[perm]
            kw = {} if free_hint is None else {"shard_hint": free_hint}
            sj = oj.free(sj, jnp.asarray(fo), jnp.asarray(fs),
                         jnp.asarray(fo >= 0), **kw)
            st = ot.free(st, torch.from_numpy(fo), torch.from_numpy(fs),
                         torch.from_numpy(fo >= 0), **kw)
        else:
            sizes = rng.choice([256, 512, 1024, 4096, 8192], N,
                               p=[.6, .15, .1, .1, .05]).astype(np.int32)
            mask = rng.random(N) < 0.9
            h = hint_of(rng, step)
            sj, oj_ = oj.alloc(sj, jnp.asarray(sizes), jnp.asarray(mask),
                               shard_hint=(jnp.asarray(h)
                                           if isinstance(h, np.ndarray)
                                           else h))
            st, ot_ = ot.alloc(st, torch.from_numpy(sizes),
                               torch.from_numpy(mask), shard_hint=h)
            np.testing.assert_array_equal(np.asarray(oj_), ot_.numpy(),
                                          err_msg=f"offsets, op {step}")
            live += [(a, b) for a, b in zip(ot_.tolist(), sizes.tolist())
                     if a >= 0]
        _same(sj, st, f"op {step}")
    return sj, st


def _walk_bins(ot, st):
    lay = ot.layout.shard
    return st.ctl[:, lay.off_t_walk:lay.off_t_walk
                  + arena.TELE_WALK_BINS].sum(0).tolist()


@pytest.mark.parametrize("mode", ("hashed", "hinted", "exhausting"))
def test_sharded_alloc_free_traces_match_reference(mode):
    """Hashed homes, per-lane hint arrays (negative and ≥ S included),
    and every lane homed on shard 0 until it is exhausted, so that lanes
    are served at attempts 1-3: words (telemetry's walk-depth bins
    included) and offsets identical after every transaction."""
    oj, ot = _pair()
    hint_of = {
        "hashed": lambda rng, step: None,
        "hinted": lambda rng, step: rng.integers(-4, 8, N).astype(np.int32),
        "exhausting": lambda rng, step: np.zeros(N, np.int32),
    }[mode]
    _, st = _trace(oj, ot, seed=1, ops_=28, hint_of=hint_of)
    bins = _walk_bins(ot, st)
    assert bins[0] > 0
    if mode == "exhausting":
        assert bins[1] > 0 and bins[2] > 0 and bins[3] > 0, bins


def test_pinned_fast_path_matches_reference():
    """A static int hint with ``overflow_walk=0`` (Python and numpy
    ints) serves every lane from one shard alone; frees pinned to a
    shard drop the lanes that live elsewhere."""
    oj, ot = _pair(walk=0)
    _, st = _trace(oj, ot, seed=2, ops_=16,
                   hint_of=lambda rng, step: (2 if step % 2
                                              else np.int32(6)),
                   free_hint=2)
    lay = ot.layout.shard
    used = st.ctl[:, lay.off_t_alloc:lay.off_t_alloc
                  + lay.num_classes].sum(1).tolist()
    assert used[2] > 0 and used[0] == used[1] == used[3] == 0
    assert _walk_bins(ot, st)[1:] == [0] * 7


@pytest.fixture(scope="module")
def churned():
    """A sharded arena (both packages) after a trace that homes every
    lane on shard 0 and frees two grants of three: overflowed pages on
    shards 1-3, stranded pages everywhere, unequal loads."""
    oj, ot = _pair()
    sj, st = oj.init(), ot.init()
    rng = np.random.default_rng(3)
    sizes = np.full(N, 256, np.int32)
    live = []
    for _ in range(30):
        mask = rng.random(N) < 0.9
        h = np.zeros(N, np.int32)
        sj, oj_ = oj.alloc(sj, jnp.asarray(sizes), jnp.asarray(mask),
                           shard_hint=jnp.asarray(h))
        st, ot_ = ot.alloc(st, torch.from_numpy(sizes),
                           torch.from_numpy(mask), shard_hint=h)
        np.testing.assert_array_equal(np.asarray(oj_), ot_.numpy())
        live += [x for x in ot_.tolist() if x >= 0]
    drop = [x for i, x in enumerate(live) if i % 3]
    rng.shuffle(drop)
    for i in range(0, len(drop), N):
        fo = np.full(N, -1, np.int32)
        fo[:len(drop[i:i + N])] = drop[i:i + N]
        sj = oj.free(sj, jnp.asarray(fo), jnp.asarray(sizes),
                     jnp.asarray(fo >= 0))
        st = ot.free(st, torch.from_numpy(fo), torch.from_numpy(sizes),
                     torch.from_numpy(fo >= 0))
    _same(sj, st, "churn")
    return oj, ot, sj, st


def _copy(oj, ot, sj, st):
    return (jshards.ShardedArena(mem=jnp.asarray(np.asarray(sj.mem)),
                                 ctl=jnp.asarray(np.asarray(sj.ctl))),
            shards.ShardedArena(mem=st.mem.clone(), ctl=st.ctl.clone()))


def test_sharded_plan_and_migrate_match_reference(churned):
    """A sharded compaction wave (per-shard plans concatenated), then a
    rebalance wave (most- to least-loaded shard): identical plans,
    ``shard_live_words`` and words after each wave; ``frag_stats`` per
    shard identical before and after."""
    oj, ot, sj, st = churned
    sj, st = _copy(oj, ot, sj, st)
    kw = {}

    def same_stats(what):
        fj, ft = oj.frag_stats(sj), ot.frag_stats(st)
        for k in ("free_words", "largest_free_extent", "frag_ratio"):
            np.testing.assert_array_equal(np.asarray(fj[k]),
                                          np.asarray(ft[k]),
                                          err_msg=f"{what}: {k}")
            assert len(ft[k]) == S

    same_stats("churned")
    moved = 0
    for wave in ("defrag", "rebalance"):
        lw_j = jshards.shard_live_words(oj.cfg, S, "chunk", "vl", sj.mem,
                                        sj.ctl)
        lw_t = shards.shard_live_words(ot.cfg, S, "chunk", "vl", st.mem,
                                       st.ctl)
        np.testing.assert_array_equal(np.asarray(lw_j), lw_t.numpy())
        sj, fj = getattr(oj, wave)(sj, **kw)
        st, ft = getattr(ot, wave)(st, **kw)
        for a, b, nm in zip(fj, ft, ("src", "dst", "sizes")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{wave}: {nm}")
        _same(sj, st, wave)
        same_stats(wave)
        n = int((ft.src >= 0).sum())
        assert n > 0, wave
        moved += n
        if wave == "rebalance":
            Ws = ot.layout.shard_words
            sh = ft.src[ft.src >= 0] // Ws, ft.dst[ft.dst >= 0] // Ws
            assert bool((sh[0] != sh[1]).all())


def test_plans_truncated_match_reference(churned):
    """Both plans cut at narrow tables (the concatenated per-shard plan
    at 8 and 40 moves, the rebalance plan at 1 and 5), and the no-op
    rebalance plan of a balanced (fresh) arena."""
    from repro.core import defrag as jdefrag
    from repro_torch.core import defrag
    oj, ot, sj, st = churned
    for m in (8, 40):
        want = jdefrag.sharded_plan_math(oj.cfg, S, "chunk", "vl", sj.mem,
                                         sj.ctl, max_moves=m)
        got = defrag.sharded_plan_math(ot.cfg, S, "chunk", "vl", st.mem,
                                       st.ctl, max_moves=m)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert int((got[0] >= 0).sum()) == m
    for m in (1, 5):
        want = jshards.rebalance_plan_math(oj.cfg, S, "chunk", "vl", sj.mem,
                                           sj.ctl, max_moves=m)
        got = shards.rebalance_plan_math(ot.cfg, S, "chunk", "vl", st.mem,
                                         st.ctl, max_moves=m)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    fresh = ot.init()
    src, _, _ = shards.rebalance_plan_math(ot.cfg, S, "chunk", "vl",
                                           fresh.mem, fresh.ctl,
                                           max_moves=8)
    assert src.tolist() == [-1] * 8


def test_shard_knobs_validated():
    """The reference's ``ValueError``s (``test_alloc_txn_parity.py``)."""
    cfg = HeapConfig(total_bytes=1 << 16, chunk_bytes=1 << 11,
                     min_page_bytes=16)
    for kw, match in ((dict(num_shards=5), "num_chunks"),
                      (dict(num_shards=0), "num_shards"),
                      (dict(num_shards=4, overflow_walk=-1),
                       "overflow_walk"),
                      (dict(overflow_walk=2), "overflow_walk")):
        with pytest.raises(ValueError, match=match):
            JOuro(JHeap(**cfg.__dict__), "vl_chunk", **kw)
        with pytest.raises(ValueError, match=match):
            Ouroboros(cfg, "vl_chunk", device="cpu", **kw)
    o = Ouroboros(cfg, "vl_chunk", device="cpu")
    sizes = torch.full((4,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="shard_hint"):
        o.alloc(o.init(), sizes, torch.ones(4, dtype=torch.bool),
                shard_hint=0)
    with pytest.raises(ValueError, match="shard_hint"):
        o.free(o.init(), sizes, sizes, torch.ones(4, dtype=torch.bool),
               shard_hint=0)
    with pytest.raises(ValueError, match="rebalance"):
        o.rebalance(o.init())
    with pytest.raises(ValueError, match="shard_hint"):
        shards.home_shards(8, 4, np.zeros(5, np.int32))
    assert [shards.resolve_walk(4, w) for w in (None, 99, 1, 0)] == \
        [3, 3, 1, 0]
    assert shards.static_hint(np.int64(3)) == 3
    assert shards.static_hint(True) is None
    assert shards.static_hint(torch.zeros(4)) is None
    o4 = Ouroboros(cfg, "vl_chunk", device="cpu", num_shards=4,
                   overflow_walk=1)
    assert o4.walk == 1 and o4.layout.num_shards == 4


def test_shard_views_match_reference(churned):
    """The global heap view and its inverse, the owning shard of global
    offsets, and one shard's slab as a single arena (views: a
    single-arena transaction on it updates the sharded words)."""
    oj, ot, sj, st = churned
    slay, jlay = ot.layout, oj.layout
    heap = shards.heap_of(slay, st)
    np.testing.assert_array_equal(heap.numpy(),
                                  np.asarray(jshards.heap_of(jlay, sj)))
    offs = np.asarray([-1, 0, 12287, 12288, 49151], np.int32)
    np.testing.assert_array_equal(
        shards.shard_of(slay, torch.from_numpy(offs)).numpy(),
        np.asarray(jshards.shard_of(jlay, jnp.asarray(offs))))
    cp = shards.ShardedArena(mem=st.mem.clone(), ctl=st.ctl.clone())
    tag = torch.arange(heap.numel(), dtype=torch.int32)
    shards.with_heap(slay, cp, tag)
    want = jshards.with_heap(jlay, sj, jnp.asarray(tag.numpy()))
    np.testing.assert_array_equal(cp.mem.numpy(), np.asarray(want.mem))
    sub = shards.take_shard(cp, 2)
    assert sub.mem.data_ptr() == cp.mem[2].data_ptr()
    np.testing.assert_array_equal(
        sub.mem.numpy(), np.asarray(jshards.take_shard(want, 2).mem))
    other = arena.Arena(mem=st.mem[1].clone(), ctl=st.ctl[1].clone())
    shards.with_shard(cp, 2, other)
    assert torch.equal(cp.mem[2], st.mem[1]) and torch.equal(cp.ctl[2],
                                                             st.ctl[1])


def test_kv_allocator_sizing_matches_reference():
    from repro.paged import kv_cache as JKV
    from repro_torch.paged import kv_cache as TKV
    for pages, s in ((256, 4), (96, 4), (96, 2), (16, 4), (1000, 1)):
        jo, jw, jp = JKV.make_kv_allocator(pages, num_shards=s)
        to, tw, tp = TKV.make_kv_allocator(pages, device="cpu",
                                           num_shards=s)
        assert (tw, tp) == (jw, jp)
        assert to.cfg.__dict__ == jo.cfg.__dict__
        assert to.num_shards == jo.num_shards == s


# --------------------------------------------------------------------------
# the serving engine with shards, port against reference
# --------------------------------------------------------------------------

STATS = ("allocs", "frees", "alloc_failures", "alloc_txns", "defrag_waves",
         "auto_defrag_waves", "pages_migrated", "evictions", "num_shards",
         "shard_pages_live", "alloc_overflows", "rebalance_waves",
         "free_words", "largest_free_extent", "frag_ratio")


@pytest.fixture(scope="module")
def models():
    cfg = jget("qwen2-0.5b").smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_arch("qwen2-0.5b").smoke()
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


def _engines(models, **kw):
    jm, jp, tm, tp = models
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=False, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu", **kw)
    return je, te


def _submit(je, te, lengths, max_new, seed=0):
    rng = np.random.default_rng(seed)
    for n in lengths:
        p = rng.integers(2, 500, n)
        assert je.submit(p, max_new) == te.submit(p, max_new)


def _same_engines(je, te, done_j, done_t):
    want = {r.uid: r.out_tokens for r in done_j}
    got = {r.uid: r.out_tokens for r in done_t}
    assert got == want
    for k in STATS:
        assert te.stats[k] == je.stats[k], k
    _same(je.alloc_state, te.alloc_state, "engine arena")
    np.testing.assert_array_equal(te.caches.kv.page_table.numpy(),
                                  np.asarray(je.caches.kv.page_table))
    assert te.stats["shard_pages_live"] == [0] * te.num_shards
    assert te.stats["allocs"] == te.stats["frees"]
    return got


def test_engine_sharded_allocator_matches_reference(models):
    """``tests/test_system.py``'s sharded engine: every slot homes on
    ``slot % 2``, both shards hold pages mid-flight, occupancy drains;
    tokens, stats and arena words as the reference's."""
    je, te = _engines(models, max_batch=3, max_seq=96, num_shards=2)
    assert te.stats["num_shards"] == 2
    _submit(je, te, (9, 20, 4, 15), 4)
    je.step()
    te.step()
    live = te.stats["shard_pages_live"]
    assert live == je.stats["shard_pages_live"]
    assert sum(live) == te.stats["allocs"] - te.stats["frees"]
    assert all(x > 0 for x in live)
    _same_engines(je, te, je.run_until_done(200), te.run_until_done(200))


def test_engine_rebalance_matches_reference(models):
    """``tests/test_defrag.py``'s rebalance trigger: one request on shard
    0 past a threshold of 1 page fires rebalance waves that migrate
    pages, with the reference's tokens and stats, and the same tokens
    as an engine that never rebalances."""
    je, te = _engines(models, max_batch=3, max_seq=96, num_shards=2,
                      rebalance_threshold=1)
    _submit(je, te, (30,), 10, seed=7)
    got = _same_engines(je, te, je.run_until_done(100),
                        te.run_until_done(100))
    assert te.stats["rebalance_waves"] > 0
    assert te.stats["pages_migrated"] > 0
    jm, jp, tm, tp = models
    plain = ServingEngine(tm, tp, kv_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu",
                          max_batch=3, max_seq=96, num_shards=2)
    plain.submit(np.random.default_rng(7).integers(2, 500, 30), 10)
    assert {r.uid: r.out_tokens for r in plain.run_until_done(100)} == got
    assert plain.stats["rebalance_waves"] == 0


def _cotenant(je, te, size, lanes, keep, hint=None):
    """A co-tenant of the arena takes ``lanes`` extents of ``size`` bytes
    (homed on ``hint``, or hashed) and frees all but ``keep``."""
    sizes = np.full(lanes, size, np.int32)
    h = None if hint is None else np.full(lanes, hint, np.int32)
    je.alloc_state, oj = je.ouro.alloc(
        je.alloc_state, jnp.asarray(sizes), jnp.ones(lanes, bool),
        shard_hint=None if h is None else jnp.asarray(h))
    te.alloc_state, ot = te.ouro.alloc(
        te.alloc_state, torch.from_numpy(sizes),
        torch.ones(lanes, dtype=torch.bool),
        shard_hint=None if h is None else torch.from_numpy(h))
    offs = ot.numpy()
    np.testing.assert_array_equal(np.asarray(oj), offs)
    granted = np.nonzero(offs >= 0)[0]
    back = np.full(lanes, -1, np.int32)
    back[granted[keep:]] = offs[granted[keep:]]
    je.alloc_state = je.ouro.free(je.alloc_state, jnp.asarray(back),
                                  jnp.asarray(sizes), jnp.asarray(back >= 0))
    te.alloc_state = te.ouro.free(te.alloc_state, torch.from_numpy(back),
                                  torch.from_numpy(sizes),
                                  torch.from_numpy(back >= 0))


def test_engine_sharded_pressure_matches_reference(models):
    """A co-tenant holds most of shard 0 and strands chunks in the
    2048-B class: grants overflow to shard 1, a grant fails and a
    sharded defrag wave runs, with the reference's tokens, stats and
    words (``frag_ratio`` per shard)."""
    je, te = _engines(models, max_batch=3, max_seq=96, num_pages=16,
                      num_shards=2, defrag_threshold=0.5)
    _cotenant(je, te, 256, 64, keep=60, hint=0)
    _cotenant(je, te, 2048, 16, keep=0)
    _submit(je, te, (20, 18, 22, 30, 40), 24, seed=0)
    _same_engines(je, te, je.run_until_done(300), te.run_until_done(300))
    assert te.stats["alloc_overflows"] > 0
    assert te.stats["alloc_failures"] > 0
    assert te.stats["defrag_waves"] > 0
    assert isinstance(te.stats["frag_ratio"], list)


def test_engine_validates_shard_knobs(models):
    jm, jp, tm, tp = models
    for kw, match in ((dict(num_shards=0), "num_shards"),
                      (dict(num_shards=1.5), "num_shards"),
                      (dict(rebalance_threshold=4), "rebalance_threshold"),
                      (dict(num_shards=2, rebalance_threshold=0),
                       "rebalance_threshold")):
        with pytest.raises(ValueError, match=match):
            JEngine(jm, jp, max_batch=2, max_seq=64, **kw)
        with pytest.raises(ValueError, match=match):
            ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu",
                          **kw)


def test_launch_cli_num_shards_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--requests", "4",
                     "--max-new", "6", "--max-batch", "2", "--max-seq", "96",
                     "--num-shards", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("REQ ") == 4 and "served 4 requests" in out
    assert "'num_shards': 2" in out
    assert "'shard_pages_live': [0, 0]" in out
