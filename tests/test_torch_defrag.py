"""The port's defragmentation wave and the serving engine's
allocation-failure path, held to the JAX reference.

The same numpy-seeded traces run through the reference
(``repro.core.Ouroboros(cfg, "vl_chunk")``, jnp backend, and once its
whole-lowering Pallas kernel in interpret mode) and the port
(``device="cpu"``, where ``defrag_txn`` runs its plain version
``defrag.migrate_math``).  Forwarding tables and arena words must be
identical; the engine must give the same tokens per uid, the same
stats and the same final arena words.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.core import HeapConfig as JHeap, Ouroboros as JOuro
from repro.core import defrag as jdefrag
from repro.models.model import build_model as jbuild
from repro.paged import kv_cache as JKV
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.core import HeapConfig, Ouroboros, arena, defrag
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine

# the reference test's geometry: 16 chunks of 512 words, 64-B pages
CFG = dict(total_bytes=1 << 15, chunk_bytes=1 << 11, min_page_bytes=64)
N = 16
PAGE = 64


def _kv_cfg(num_pages):
    """The engine allocator's geometry (``make_kv_allocator``)."""
    return dict(KV.make_kv_allocator(num_pages, device="cpu")[0]
                .cfg.__dict__)


def _pair(cfgkw, **kw):
    return (JOuro(JHeap(**cfgkw), "vl_chunk", **kw),
            Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device="cpu"))


def _same(js, ts, what):
    for name in ("mem", "ctl"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        diff = np.nonzero(a != b)[0]
        assert diff.size == 0, f"{what}: {name} differs at words {diff[:8]}"


def _churn(oj, ot, sj, st, seed, page=PAGE, until_full=False, rounds=14,
           keep_every=5):
    """The reference test's churn (``tests/test_defrag.py::_churn``) in
    lockstep on both packages; returns (sj, st, kept offsets)."""
    rng = np.random.default_rng(seed)
    sizes = np.full(N, page, np.int32)
    live, fails = [], 0
    for step in range(200):
        if until_full:
            if fails >= 2:
                break
        elif step >= rounds:
            break
        mask = rng.random(N) < 0.95
        sj, oj_offs = oj.alloc(sj, jnp.asarray(sizes), jnp.asarray(mask))
        st, ot_offs = ot.alloc(st, torch.from_numpy(sizes),
                               torch.from_numpy(mask))
        np.testing.assert_array_equal(np.asarray(oj_offs), ot_offs.numpy())
        got = [int(o) for o in ot_offs.tolist() if o >= 0]
        fails = fails + 1 if not got else 0
        live.extend(got)
    keep = set(range(0, len(live), keep_every))
    kept = [o for i, o in enumerate(live) if i in keep]
    drop = [o for i, o in enumerate(live) if i not in keep]
    rng.shuffle(drop)
    for i in range(0, len(drop), N):
        fo = np.full(N, -1, np.int32)
        fo[:len(drop[i:i + N])] = drop[i:i + N]
        sj = oj.free(sj, jnp.asarray(fo), jnp.asarray(sizes),
                     jnp.asarray(fo >= 0))
        st = ot.free(st, torch.from_numpy(fo), torch.from_numpy(sizes),
                     torch.from_numpy(fo >= 0))
    _same(sj, st, "churn")
    return sj, st, kept


def _waves(cfgkw, page, seeds, max_moves=None, **kw):
    oj, ot = _pair(cfgkw, **kw)
    sj, st = oj.init(), ot.init()
    moved = 0
    for i, seed in enumerate(seeds):
        sj, st, _ = _churn(oj, ot, sj, st, seed, page=page,
                           until_full=(i == 0))
        mm = {} if max_moves is None else {"max_moves": max_moves}
        sj, fj = oj.defrag(sj, **mm)
        st, ft = ot.defrag(st, **mm)
        for a, b, nm in zip(fj, ft, ("src", "dst", "sizes")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"wave {i}: {nm}")
        _same(sj, st, f"wave {i}")
        moved += int((ft.src >= 0).sum())
    return moved


@pytest.mark.parametrize("cfgkw,page,seeds,max_moves", [
    (CFG, PAGE, (0, 1), None),
    (CFG, PAGE, (2, 3), 8),                 # truncated plans
    (_kv_cfg(96), 256, (4, 5), None),       # the engine's arena
], ids=("test-defrag-cfg", "truncated", "kv-geometry"))
def test_plan_and_migrate_match_reference(cfgkw, page, seeds, max_moves):
    """Churn → wave → churn → wave in lockstep: identical forwarding
    tables (``plan_math``) and identical arena words (``migrate_math``)
    after every wave."""
    assert _waves(cfgkw, page, seeds, max_moves) > 0


def test_migrate_matches_reference_pallas_kernel():
    """The reference's whole-lowering Pallas wave (interpret mode) ends
    on the same words."""
    assert _waves(CFG, PAGE, (0,), 16, backend="pallas",
                  lowering="whole") > 0


def test_migrate_claims_unbound_destination_chunks():
    """A plan whose destinations lie in a chunk still in the pool: the
    wave claims it (bitmap reset, full free count, bound to the move's
    class) before setting the moved bits — word for word as the
    reference."""
    oj, ot = _pair(CFG)
    sj, st = oj.init(), ot.init()
    sj, st, kept = _churn(oj, ot, sj, st, seed=9)
    cfg = HeapConfig(**CFG)
    _, _, meta = arena.unpack(ot.layout, st)
    cc = meta.chunk_class.numpy()
    wpc = cfg.words_per_chunk
    in_pool = defrag._pool_members(cfg, arena.unpack(ot.layout, st)[1].pool)
    target = int(np.nonzero(in_pool.numpy() & (cc < 0))[0][-1])
    src = np.full(8, -1, np.int32)
    dst = np.full(8, -1, np.int32)
    sizes = np.zeros(8, np.int32)
    src[:3] = kept[:3]
    dst[:3] = [target * wpc + k * 16 for k in (0, 2, 5)]  # 64-B pages
    sizes[:3] = PAGE
    # tag the moved words so the copy shows
    for o in kept[:3]:
        st.mem[o:o + 16] = o
    sj = sj._replace(mem=jnp.asarray(st.mem.numpy()))
    from repro.core import transactions as jT
    from repro_torch.core import transactions as T
    sj = jT.migrate(oj.cfg, "chunk", "vl", sj, jnp.asarray(src),
                    jnp.asarray(dst), jnp.asarray(sizes))
    st = T.migrate(cfg, "chunk", "vl", st, torch.from_numpy(src),
                   torch.from_numpy(dst), torch.from_numpy(sizes))
    _same(sj, st, "claim wave")
    _, _, meta = arena.unpack(ot.layout, st)
    assert int(meta.chunk_class[target]) == 0
    assert int(meta.free_count[target]) == cfg.pages_per_chunk(0) - 3
    assert int(st.mem[target * wpc + 32]) == kept[1]


def _tag(mem, offs, pw, tags):
    for o, t in zip(offs, tags):
        mem[o:o + pw] = t


def test_wave_reclaims_stranded_pages():
    """The reference's acceptance trace: churn strands ≥ 30 % of the
    pages and a chunk-sized allocation fails; one wave leaves the
    minimal number of bound chunks, a chunk-sized free extent and a
    lower frag ratio, keeps every live word at its forwarded offset,
    and the chunk-sized allocation then succeeds.  Same words as the
    reference throughout."""
    oj, ot = _pair(CFG)
    sj, st, kept = _churn(oj, ot, oj.init(), ot.init(), seed=0,
                          until_full=True)
    cfg = HeapConfig(**CFG)
    ppc = cfg.pages_per_chunk(0)
    pw = cfg.page_words(0)
    tags = list(range(1000, 1000 + len(kept)))
    _tag(st.mem, kept, pw, tags)
    sj = sj._replace(mem=jnp.asarray(st.mem.numpy()))
    cc = arena.unpack(ot.layout, st)[2].chunk_class
    n_bound = int((cc >= 0).sum())
    total_pages = cfg.total_words // pw
    assert (n_bound * ppc - len(kept)) / total_pages >= 0.30
    big = np.full(4, cfg.chunk_bytes, np.int32)
    sj, bj = oj.alloc(sj, jnp.asarray(big), jnp.ones(4, bool))
    st, bt = ot.alloc(st, torch.from_numpy(big), torch.ones(4, dtype=bool))
    assert (bt < 0).all() and (np.asarray(bj) < 0).all()
    fr0 = ot.frag_stats(st)["frag_ratio"]

    sj, fj = oj.defrag(sj)
    st, ft = ot.defrag(st)
    _same(sj, st, "acceptance wave")
    assert int((ft.src >= 0).sum()) > 0
    cc = arena.unpack(ot.layout, st)[2].chunk_class
    assert int((cc >= 0).sum()) == -(-len(kept) // ppc)
    fs = ot.frag_stats(st)
    assert fs["largest_free_extent"] >= cfg.words_per_chunk
    assert fs["frag_ratio"] < fr0
    fj_s = jdefrag.frag_stats_math(oj.cfg, "chunk", "vl", sj.mem, sj.ctl)
    assert (fs["free_words"], fs["largest_free_extent"]) == \
        tuple(int(x) for x in fj_s)

    moved = defrag.forward_offsets(ft, torch.tensor(kept, dtype=torch.int32))
    np.testing.assert_array_equal(
        moved.numpy(), np.asarray(jdefrag.forward_offsets(
            fj, jnp.asarray(kept, jnp.int32))))
    for o, t in zip(moved.tolist(), tags):
        assert bool((st.mem[o:o + pw] == t).all()), "live words lost"

    sj, bj = oj.alloc(sj, jnp.asarray(big), jnp.ones(4, bool))
    st, bt = ot.alloc(st, torch.from_numpy(big), torch.ones(4, dtype=bool))
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    assert bool((bt >= 0).any())


def test_forward_offsets_passthrough():
    fwd = defrag.Forwarding(src=torch.tensor([64, -1], dtype=torch.int32),
                            dst=torch.tensor([0, -1], dtype=torch.int32),
                            sizes=torch.tensor([256, 0], dtype=torch.int32))
    got = defrag.forward_offsets(fwd, torch.tensor([64, 128, -1],
                                                   dtype=torch.int32))
    assert got.tolist() == [0, 128, -1]


def test_defrag_knobs_and_launch_counts():
    ot = Ouroboros(HeapConfig(**CFG), "vl_chunk", device="cpu")
    with pytest.raises(ValueError, match="max_moves"):
        ot.defrag(ot.init(), max_moves=0)
    with pytest.raises(ValueError, match="max_moves"):
        ot.defrag(ot.init(), max_moves=2.5)
    ops.reset_launches()
    st, fwd = ot.defrag(ot.init())
    assert fwd.src.shape == (128,) and int((fwd.src >= 0).sum()) == 0
    assert ops.LAUNCHES["defrag_txn"] == 0     # the CPU runs the math


# --------------------------------------------------------------------------
# KV forwarding
# --------------------------------------------------------------------------

def test_kv_apply_forwarding_matches_reference():
    """Rows move in place (all layers), matching page-table entries are
    rewritten, and reads through the table are unchanged: the case of
    ``tests/test_defrag.py`` plus a multi-page extent, against the
    reference."""
    rng = np.random.default_rng(0)
    L, NP, B, Pn, H, D = 2, 8, 2, 3, 1, 4
    k = rng.standard_normal((L, NP, 16, H, D)).astype(np.float32)
    v = rng.standard_normal((L, NP, 16, H, D)).astype(np.float32)
    table = np.asarray([[5, 2, -1], [7, 6, -1]], np.int32)
    wpp = 64
    src = np.asarray([5 * wpp, 7 * wpp, 6 * wpp, -1], np.int32)
    dst = np.asarray([0 * wpp, 1 * wpp, 3 * wpp, -1], np.int32)
    sizes = np.asarray([256, 256, 256, 0], np.int32)

    jkv = JKV.init_paged_kv(L, NP, B, Pn, H, D, kv_dtype=jnp.float32)
    jkv = jkv._replace(layers=jkv.layers._replace(k=jnp.asarray(k),
                                                  v=jnp.asarray(v)),
                       page_table=jnp.asarray(table))
    jfwd = jdefrag.Forwarding(*(jnp.asarray(x) for x in (src, dst, sizes)))
    jkv2 = JKV.apply_forwarding(jkv, jfwd, wpp)

    tkv = KV.init_paged_kv(L, NP, B, Pn, H, D, kv_dtype=torch.float32)
    tkv.layers.k.copy_(torch.from_numpy(k))
    tkv.layers.v.copy_(torch.from_numpy(v))
    tkv.page_table.copy_(torch.from_numpy(table))
    k_id = tkv.layers.k.data_ptr()
    tfwd = defrag.Forwarding(*(torch.from_numpy(x) for x in
                               (src, dst, sizes)))
    tkv2 = KV.apply_forwarding(tkv, tfwd, wpp)
    assert tkv2.layers.k.data_ptr() == k_id          # in place
    assert tkv2.page_table.tolist() == [[0, 2, -1], [1, 3, -1]]
    np.testing.assert_array_equal(tkv2.page_table.numpy(),
                                  np.asarray(jkv2.page_table))
    np.testing.assert_array_equal(tkv2.layers.k.numpy(),
                                  np.asarray(jkv2.layers.k))
    np.testing.assert_array_equal(tkv2.layers.v.numpy(),
                                  np.asarray(jkv2.layers.v))
    for a, b in zip(KV.forwarding_page_map(tfwd, wpp, 2),
                    JKV.forwarding_page_map(jfwd, wpp, 2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a two-page extent (512 B) expands to two page moves
    f2 = defrag.Forwarding(src=torch.tensor([4 * wpp], dtype=torch.int32),
                           dst=torch.tensor([0], dtype=torch.int32),
                           sizes=torch.tensor([512], dtype=torch.int32))
    sp, dp = KV.forwarding_page_map(f2, wpp, 4)
    assert sp.tolist() == [4, 5, -1, -1] and dp.tolist() == [0, 1, -1, -1]


# --------------------------------------------------------------------------
# the serving engine's allocation-failure path, port against reference
# --------------------------------------------------------------------------

STATS = ("allocs", "frees", "alloc_failures", "alloc_txns", "defrag_waves",
         "auto_defrag_waves", "pages_migrated", "evictions", "cancels")


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


def _cotenant(je, te, size, lanes, keep):
    """A co-tenant of the same arena allocates ``lanes`` extents of
    ``size`` bytes and frees all but the first ``keep`` granted ones.
    Returns the offsets it still holds."""
    sizes = np.full(lanes, size, np.int32)
    je.alloc_state, oj = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                       jnp.ones(lanes, bool))
    te.alloc_state, ot = te.ouro.alloc(te.alloc_state,
                                       torch.from_numpy(sizes),
                                       torch.ones(lanes, dtype=torch.bool))
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
    return offs[granted[:keep]]


def _release(je, te, held, size):
    lanes = max(len(held), 1)
    fo = np.full(lanes, -1, np.int32)
    fo[:len(held)] = held
    sizes = np.full(lanes, size, np.int32)
    je.alloc_state = je.ouro.free(je.alloc_state, jnp.asarray(fo),
                                  jnp.asarray(sizes), jnp.asarray(fo >= 0))
    te.alloc_state = te.ouro.free(te.alloc_state, torch.from_numpy(fo),
                                  torch.from_numpy(sizes),
                                  torch.from_numpy(fo >= 0))


def _submit(je, te, prompts, max_new):
    for p in prompts:
        assert je.submit(p, max_new) == te.submit(p, max_new)


def _same_engines(je, te, done_j, done_t):
    want = {r.uid: r.out_tokens for r in done_j}
    got = {r.uid: r.out_tokens for r in done_t}
    assert got == want
    shared = set(je.stats) & set(te.stats)
    assert set(STATS) <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    _same(je.alloc_state, te.alloc_state, "engine arena")
    np.testing.assert_array_equal(te.caches.kv.page_table.numpy(),
                                  np.asarray(je.caches.kv.page_table))
    return got


def _prompts(n, lengths, seed=0, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, int(lengths[i % len(lengths)]))
            for i in range(n)]


def test_engine_survives_exhaustion_trace(models):
    """The reference's exhaustion trace: a co-tenant binds chunks to the
    2048-B class and frees them, stranding them for the engine's 256-B
    pages; the engine reclaims them with defrag waves and finishes."""
    je, te = _engines(models, max_batch=2, max_seq=64, num_pages=16)
    _cotenant(je, te, 2048, 16, keep=0)
    _submit(je, te, _prompts(2, [40]), 8)
    got = _same_engines(je, te, je.run_until_done(100),
                        te.run_until_done(100))
    assert len(got) == 2 and all(len(t) == 8 for t in got.values())
    assert te.stats["alloc_failures"] > 0
    assert te.stats["defrag_waves"] > 0
    assert te.stats["allocs"] == te.stats["frees"]


def test_engine_evicts_when_demand_exceeds_the_heap(models):
    """A co-tenant holds all but a few pages live, so defrag cannot
    help: three requests whose pages outgrow what is left.  The
    youngest slot is evicted and requeued, and every request still
    completes with the tokens of an engine that never ran short."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=3, max_seq=64, num_pages=16)
    je, te = _engines(models, **kw)
    held = _cotenant(je, te, 256, 64, keep=56)
    prompts = _prompts(3, [20, 18, 22], seed=3)
    _submit(je, te, prompts, 20)
    done_j, done_t = je.run_until_done(300), te.run_until_done(300)
    got = _same_engines(je, te, done_j, done_t)
    assert len(got) == 3
    assert te.stats["evictions"] > 0 and te.stats["defrag_waves"] > 0
    assert te.stats["allocs"] == te.stats["frees"]
    _release(je, te, held, 256)
    roomy = ServingEngine(tm, tp, kv_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu", **kw)
    for p in prompts:
        roomy.submit(p, 20)
    assert {r.uid: r.out_tokens for r in roomy.run_until_done()} == got
    assert roomy.stats["evictions"] == 0


def _checkerboard(je, te, lanes=32):
    """A co-tenant takes ``lanes`` 256-B pages and frees every other
    one: a frag ratio that stays high while the engine serves."""
    sizes = np.full(lanes, 256, np.int32)
    je.alloc_state, oj = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                       jnp.ones(lanes, bool))
    te.alloc_state, ot = te.ouro.alloc(te.alloc_state,
                                       torch.from_numpy(sizes),
                                       torch.ones(lanes, dtype=torch.bool))
    offs = ot.numpy()
    np.testing.assert_array_equal(np.asarray(oj), offs)
    even = (np.arange(lanes) % 2 == 0) & (offs >= 0)
    je.alloc_state = je.ouro.free(je.alloc_state, jnp.asarray(offs),
                                  jnp.asarray(sizes), jnp.asarray(even))
    te.alloc_state = te.ouro.free(te.alloc_state, torch.from_numpy(offs),
                                  torch.from_numpy(sizes),
                                  torch.from_numpy(even))


@pytest.mark.parametrize("threshold,fires", [(0.05, True), (0.9, False)])
def test_engine_auto_defrag_threshold(models, threshold, fires):
    """Past ``defrag_threshold`` (checked after every step) the engine
    fires proactive waves (``auto_defrag_waves``), and below it none,
    with the reference's words, tokens and counts."""
    je, te = _engines(models, max_batch=2, max_seq=64, num_pages=32,
                      defrag_threshold=threshold)
    _checkerboard(je, te)
    _submit(je, te, _prompts(3, [18, 9], seed=4), 6)
    _same_engines(je, te, je.run_until_done(100), te.run_until_done(100))
    assert (te.stats["auto_defrag_waves"] > 0) == fires
    assert te.stats["defrag_waves"] >= te.stats["auto_defrag_waves"]


def test_engine_cancel_waiting_active_retired(models):
    """``cancel`` in all three states, in lockstep with the reference:
    a waiting uid is removed, an active uid frees its slot's pages, a
    retired or unknown uid is a no-op returning False."""
    je, te = _engines(models, max_batch=2, max_seq=64)
    _submit(je, te, _prompts(4, [6], seed=5), 4)
    je.step()
    te.step()
    waiting = [r.uid for r in te.waiting]
    active = sorted(r.uid for r in te.slot_req if r is not None)
    assert len(waiting) == 2 and len(active) == 2
    for uid in (waiting[0], active[0], active[0], 10_000):
        assert je.cancel(uid) == te.cancel(uid)
    assert te.stats["allocs"] - te.stats["frees"] < 2 * 2
    done_j, done_t = je.run_until_done(100), te.run_until_done(100)
    assert je.cancel(done_j[0].uid) is te.cancel(done_t[0].uid) is False
    got = _same_engines(je, te, done_j, done_t)
    assert set(got) == {1, 2, 3, 4} - {waiting[0], active[0]}
    assert te.stats["cancels"] == 2
    assert te.stats["allocs"] == te.stats["frees"]


@pytest.mark.parametrize("kw,match", [
    (dict(defrag_threshold=0.0), "defrag_threshold"),
    (dict(defrag_threshold=1.0), "defrag_threshold"),
    (dict(defrag_threshold=-0.5), "defrag_threshold"),
    (dict(defrag_threshold=1.5), "defrag_threshold"),
])
def test_engine_validates_defrag_knobs(models, kw, match):
    jm, jp, tm, tp = models
    with pytest.raises(ValueError, match=match):
        JEngine(jm, jp, max_batch=2, max_seq=64, **kw)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu", **kw)


def test_launch_cli_defrag_threshold_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--requests", "4",
                     "--max-new", "6", "--max-batch", "2", "--max-seq", "96",
                     "--defrag-threshold", "0.05", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("REQ ") == 4 and "served 4 requests" in out
    assert "'auto_defrag_waves'" in out
    with pytest.raises(ValueError, match="defrag_threshold"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--requests", "1",
                    "--defrag-threshold", "2", "--device", "cpu"])
