"""The port's allocator slice held to the JAX reference, word for word.

The same seeded alloc/free traces (mixed size classes, over-large and
masked lanes, segment grow/shrink with tiny chunks, heap exhaustion)
run through ``repro.core.Ouroboros(..., "vl_chunk", backend="jnp")`` and
the port's ``repro_torch.core.Ouroboros(..., device="cpu")``; ``mem``,
``ctl`` and the granted offsets must be identical after every
transaction.  One case also runs the reference's Pallas kernel
(``lowering="whole"``, interpret mode).  Lane widths stay fixed so the
reference compiles few shapes.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import HeapConfig as JHeap, Ouroboros as JOuro
from repro.core import arena as jarena
from repro.core import groups as jgroups
from repro.core import heap as jheap
from repro.obs import telemetry as jtele

from repro_torch.core import HeapConfig, Ouroboros, arena, groups, heap
from repro_torch.kernels import ops
from repro_torch.obs import telemetry
from repro_torch.paged.kv_cache import make_kv_allocator

GOLDEN = pathlib.Path(__file__).parent / "golden" / "arena_layout.txt"
CFG = dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16)
GROW_CFG = dict(total_bytes=1 << 16, chunk_bytes=64, min_page_bytes=16)
TINY_CFG = dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16)
SIZES = [16, 24, 100, 256, 1000, 2048, 8192]   # 8192 > chunk: fails
GROW_SIZES = [16, 32, 64, 128]                  # 128 > chunk: fails
N = 16


def _pair(cfgkw, backend="jnp", lowering="auto"):
    return (JOuro(JHeap(**cfgkw), "vl_chunk", backend=backend,
                  lowering=lowering),
            Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device="cpu"))


def _same(js, ts, what):
    for name in ("mem", "ctl"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        diff = np.nonzero(a != b)[0]
        assert diff.size == 0, f"{what}: {name} differs at words {diff[:8]}"


def _replay(cfgkw, menu, seed, ops_, bias_alloc=0.6, pmask=0.85, **kw):
    """Lockstep replay; returns (reference arena, port arena, failed)."""
    oj, ot = _pair(cfgkw, **kw)
    sj, st = oj.init(), ot.init()
    _same(sj, st, "init")
    rng = np.random.default_rng(seed)
    live, failed = [], 0
    for step in range(ops_):
        if not live or rng.random() < bias_alloc:
            sizes = rng.choice(menu, N).astype(np.int32)
            mask = rng.random(N) < pmask
            sj, oj_offs = oj.alloc(sj, jnp.asarray(sizes), jnp.asarray(mask))
            st, ot_offs = ot.alloc(st, torch.from_numpy(sizes),
                                   torch.from_numpy(mask))
            np.testing.assert_array_equal(
                np.asarray(oj_offs), ot_offs.numpy(),
                err_msg=f"offsets differ at op {step}")
            failed += int(((ot_offs < 0) & torch.from_numpy(mask)).sum())
            live += [(int(o), int(s)) for o, s in
                     zip(ot_offs.tolist(), sizes.tolist()) if o >= 0]
        else:
            k = min(len(live), int(rng.integers(1, N + 1)))
            pick = rng.choice(len(live), k, replace=False)
            sel = set(pick.tolist())
            drop = [live[i] for i in pick]
            live = [x for i, x in enumerate(live) if i not in sel]
            fo = np.full(N, -1, np.int32)
            fs = np.zeros(N, np.int32)
            fo[:k] = [o for o, _ in drop]
            fs[:k] = [s for _, s in drop]
            perm = rng.permutation(N)       # holes anywhere in the lanes
            fo, fs = fo[perm], fs[perm]
            sj = oj.free(sj, jnp.asarray(fo), jnp.asarray(fs),
                         jnp.asarray(fo >= 0))
            st = ot.free(st, torch.from_numpy(fo), torch.from_numpy(fs),
                         torch.from_numpy(fo >= 0))
        _same(sj, st, f"op {step}")
    return oj, sj, ot, st, failed


# ---- layout --------------------------------------------------------------

def test_layout_matches_golden_byte_for_byte():
    cfg = HeapConfig(**CFG)
    got = "\n".join(arena.layout(cfg, k, f).describe(blocks=True)
                    for k in arena.KINDS
                    for f in arena.QUEUE_FAMILIES) + "\n"
    assert got == GOLDEN.read_text()


@pytest.mark.parametrize("kind", ("page", "chunk"))
@pytest.mark.parametrize("family", ("ring", "va", "vl"))
def test_layout_matches_reference(kind, family):
    for cfgkw in (CFG, GROW_CFG):
        lj = jarena.layout(JHeap(**cfgkw), kind, family)
        lt = arena.layout(HeapConfig(**cfgkw), kind, family)
        assert lt.describe() == lj.describe()
        assert lt.tele_fields() == lj.tele_fields()
        assert lt.wrap_capacity == lj.wrap_capacity
        assert [(r.name, r.offset, r.shape) for r in lt.regions] == \
            [(r.name, r.offset, r.shape) for r in lj.regions]


@pytest.mark.parametrize("cfgkw", (CFG, GROW_CFG, TINY_CFG),
                         ids=("cfg", "grow", "tiny"))
def test_init_words_match_reference(cfgkw):
    oj, ot = _pair(cfgkw)
    _same(oj.init(), ot.init(), "init")


def test_kv_allocator_geometry_matches_reference():
    from repro.paged.kv_cache import make_kv_allocator as jmake
    for n in (64, 256, 65536):
        oj, wj, pj = jmake(n)
        ot, wt, pt = make_kv_allocator(n, device="cpu")
        assert (wt, pt) == (wj, pj)
        assert ot.cfg.total_bytes == oj.cfg.total_bytes
        assert ot.layout.describe() == oj.layout.describe()
    oj, _, _ = jmake(256)
    ot, _, _ = make_kv_allocator(256, device="cpu")
    _same(oj.init(), ot.init(), "kv allocator init")


# ---- device math -------------------------------------------------------------

def test_size_to_class_and_clz_match_reference():
    sizes = np.array([-(1 << 31), -5, -1, 0, 1, 15, 16, 17, 31, 32, 33, 255,
                      256, 257, 1000, 2047, 2048, 2049, 8192, (1 << 31) - 1],
                     np.int32)
    for cfgkw in (CFG, GROW_CFG, dict(total_bytes=1 << 20,
                                      chunk_bytes=4096, min_page_bytes=256)):
        want = np.asarray(jheap.size_to_class_device(JHeap(**cfgkw),
                                                     jnp.asarray(sizes)))
        got = heap.size_to_class_device(HeapConfig(**cfgkw),
                                        torch.from_numpy(sizes)).numpy()
        np.testing.assert_array_equal(got, want)
    x = np.array([0, 1, 2, 3, 255, 256, 65535, 1 << 20, (1 << 31) - 1],
                 np.int32)
    np.testing.assert_array_equal(
        heap._clz32(torch.from_numpy(x)).numpy(),
        np.asarray(jheap._clz32(jnp.asarray(x))))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_groups_match_reference(seed):
    rng = np.random.default_rng(seed)
    C = 5
    cls = rng.integers(-1, C + 1, 64).astype(np.int32)   # some out of range
    mask = rng.random(64) < 0.7
    rj, cj = jgroups.masked_rank(jnp.asarray(cls), jnp.asarray(mask), C)
    rt, ct = groups.masked_rank(torch.from_numpy(cls),
                                torch.from_numpy(mask), C)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(
        groups.segment_counts(torch.from_numpy(cls), torch.from_numpy(mask),
                              C).numpy(),
        np.asarray(jgroups.segment_counts(jnp.asarray(cls),
                                          jnp.asarray(mask), C)))
    x = rng.integers(0, 9, 64).astype(np.int32)
    np.testing.assert_array_equal(
        groups.masked_prefix_sum(torch.from_numpy(x),
                                 torch.from_numpy(mask)).numpy(),
        np.asarray(jgroups.masked_prefix_sum(jnp.asarray(x),
                                             jnp.asarray(mask))))


# ---- transactions ------------------------------------------------------------

@pytest.mark.parametrize("case", [
    (CFG, SIZES, 0, 10),
    (CFG, SIZES, 1, 14),
    (GROW_CFG, GROW_SIZES, 4, 20),
], ids=("mixed-seed0", "mixed-seed1", "segment-churn"))
def test_trace_word_for_word(case):
    cfgkw, menu, seed, n_ops = case
    _, sj, _, st, _ = _replay(cfgkw, menu, seed, n_ops)
    lay = arena.layout(HeapConfig(**cfgkw), "chunk", "vl")
    tele = st.ctl[lay.core_ctl_words:]
    assert int(tele.sum()) > 0
    if cfgkw is GROW_CFG:
        # consumed vl segments went back to the pool inside the trace
        assert telemetry.decode(lay, st.ctl)["t_shrink"] > 0


def test_exhaustion_trace_word_for_word():
    """A heap far too small for the traffic: failed lanes, pool pops
    past the inventory, and segment growth out of an empty pool."""
    _, sj, _, st, failed = _replay(TINY_CFG, [16, 32, 64], 5, 40,
                                   bias_alloc=0.8)
    assert failed > 0
    lay = arena.layout(HeapConfig(**TINY_CFG), "chunk", "vl")
    assert telemetry.decode(lay, st.ctl)["t_fail"].sum() == failed


def test_trace_matches_reference_pallas_kernel():
    """The reference's fused Pallas transaction (whole lowering, run in
    interpret mode) is held to the same words."""
    _replay(CFG, SIZES, 2, 6, backend="pallas", lowering="whole")


def test_telemetry_decode_matches_reference():
    oj, sj, ot, st, _ = _replay(GROW_CFG, GROW_SIZES, 4, 10)
    dj = jtele.decode(oj.layout, np.asarray(sj.ctl))
    dt = telemetry.decode(ot.layout, st.ctl)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(np.asarray(dt[k]), np.asarray(dj[k]))
    assert telemetry.totals(ot.layout, st.ctl) == \
        jtele.totals(oj.layout, np.asarray(sj.ctl))


def test_frag_stats_match_reference():
    oj, sj, ot, st, _ = _replay(CFG, SIZES, 6, 8)
    fj = oj.frag_stats(sj)
    ft = ot.frag_stats(st)
    assert ft["free_words"] == int(fj["free_words"])
    assert ft["largest_free_extent"] == int(fj["largest_free_extent"])
    assert ft["frag_ratio"] == float(fj["frag_ratio"])


def test_cpu_transactions_launch_no_kernel():
    ops.reset_launches()
    _, ot = _pair(CFG)
    st = ot.init()
    sizes = torch.full((N,), 64, dtype=torch.int32)
    mask = torch.ones(N, dtype=torch.bool)
    st, offs = ot.alloc(st, sizes, mask)
    ot.free(st, offs, sizes, mask)
    assert bool((offs >= 0).all())
    assert ops.LAUNCHES == {"alloc_txn": 0, "free_txn": 0,
                            "defrag_txn": 0, "sharded_alloc_txn": 0,
                            "sharded_free_txn": 0, "sharded_defrag_txn": 0,
                            "paged_attention": 0, "ssd_scan": 0,
                            "ring_txn_pop": 0, "ring_txn_push": 0,
                            "chunk_txn_claim": 0, "ring_window": 0,
                            "bitmap_select": 0}


@pytest.mark.parametrize("variant", ("page", "chunk", "va_page", "vl_page",
                                     "va_chunk"))
def test_other_variants_serve_a_transaction(variant):
    """The five variants beside ``vl_chunk`` construct, init and serve
    one alloc and its free on the CPU, word for word with the
    reference (``tests/test_torch_variants.py`` holds their traces)."""
    oj = JOuro(JHeap(**CFG), variant)
    ot = Ouroboros(HeapConfig(**CFG), variant, device="cpu")
    sj, st = oj.init(), ot.init()
    _same(sj, st, "init")
    sizes = np.array([16, 64, 256, 1000] * 4, np.int32)
    ones = np.ones(N, bool)
    sj, oj_offs = oj.alloc(sj, jnp.asarray(sizes), jnp.asarray(ones))
    st, ot_offs = ot.alloc(st, torch.from_numpy(sizes),
                           torch.from_numpy(ones))
    np.testing.assert_array_equal(np.asarray(oj_offs), ot_offs.numpy())
    assert bool((ot_offs >= 0).all())
    _same(sj, st, "alloc")
    sj = oj.free(sj, oj_offs, jnp.asarray(sizes), jnp.asarray(ones))
    st = ot.free(st, ot_offs, torch.from_numpy(sizes),
                 torch.from_numpy(ones))
    _same(sj, st, "free")


def test_pack_inverts_unpack():
    _, ot = _pair(GROW_CFG)
    st = ot.init()
    st, _ = ot.alloc(st, torch.full((N,), 16, dtype=torch.int32),
                     torch.ones(N, dtype=torch.bool))
    lay = ot.layout
    q, ctx, meta = arena.unpack(lay, st)
    packed = arena.pack(lay, q, ctx, meta, tele=arena.tele_of(lay, st.ctl))
    assert torch.equal(packed.mem, st.mem) and torch.equal(packed.ctl, st.ctl)
    q.front.add_(1)                       # views write through
    assert int(st.ctl[lay.off_front]) == int(packed.ctl[lay.off_front]) + 1
