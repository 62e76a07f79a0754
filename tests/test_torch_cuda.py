"""The port's CUDA kernels held to their plain versions on the card.

These tests need an NVIDIA card and ``nvcc``; without one they skip
(the decision is made inside the fixture).  On a machine with a card,
where JAX (which ``tests/conftest.py`` imports) is absent:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HeapConfig, Ouroboros
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cfgkw,menu,n,n_ops,bias,seed", [
    (dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16),
     [16, 24, 100, 256, 1000, 2048, 8192], 32, 30, 0.7, 0),
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64], 32, 30, 0.7, 0),
    # frees into an exhausted pool that repeat a segment chunk, so two
    # revived chunks share a queue word (the last lane must win)
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64], 64, 40, 0.8, 7),
], ids=("mixed", "tiny-exhausting", "exhausted-duplicate-words"))
def test_alloc_kernels_match_plain_math_word_for_word(cuda, cfgkw, menu, n,
                                                      n_ops, bias, seed):
    o_gpu = Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device=cuda)
    o_cpu = Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device="cpu")
    sg, sc = o_gpu.init(), o_cpu.init()
    rng = np.random.default_rng(seed)
    live = []
    ops.reset_launches()
    n_alloc = n_free = 0
    for step in range(n_ops):
        if not live or rng.random() < bias:
            sizes = torch.from_numpy(rng.choice(menu, n).astype(np.int32))
            mask = torch.from_numpy(rng.random(n) < 0.85)
            sc, oc = o_cpu.alloc(sc, sizes, mask)
            sg, og = o_gpu.alloc(sg, sizes.to(cuda), mask.to(cuda))
            assert torch.equal(og.cpu(), oc), step
            live += [(int(a), int(b)) for a, b in
                     zip(oc.tolist(), sizes.tolist()) if a >= 0]
            n_alloc += 1
        else:
            k = min(len(live), int(rng.integers(1, n + 1)))
            pick = set(rng.choice(len(live), k, replace=False).tolist())
            fo = np.full(n, -1, np.int32)
            fs = np.zeros(n, np.int32)
            drop = [x for i, x in enumerate(live) if i in pick]
            live = [x for i, x in enumerate(live) if i not in pick]
            fo[:k] = [a for a, _ in drop]
            fs[:k] = [b for _, b in drop]
            perm = rng.permutation(n)
            fo_t = torch.from_numpy(fo[perm].copy())
            fs_t = torch.from_numpy(fs[perm].copy())
            sc = o_cpu.free(sc, fo_t, fs_t, fo_t >= 0)
            sg = o_gpu.free(sg, fo_t.to(cuda), fs_t.to(cuda),
                            (fo_t >= 0).to(cuda))
            n_free += 1
        assert torch.equal(sg.mem.cpu(), sc.mem), step
        assert torch.equal(sg.ctl.cpu(), sc.ctl), step
    assert ops.LAUNCHES["alloc_txn"] == n_alloc
    assert ops.LAUNCHES["free_txn"] == n_free


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_kernel_matches_plain(cuda, dtype, atol, wpp):
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D, page, P, NP = 8, 14, 2, 64, 16, 32, 300
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[2, 3] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    seq = np.array([512, 0, 77, 1, 16, 300, 511, 200], np.int32)
    args = [x.to(dtype).to(cuda) for x in (q, k, v)] + [
        torch.from_numpy(table).to(cuda), torch.from_numpy(seq).to(cuda)]
    ops.reset_launches()
    got = ops.paged_attention(*args, wpp=wpp)
    want = ref.paged_attention(*args, wpp=wpp)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    assert float((got - want).abs().max()) <= atol
    with pytest.raises(TypeError):
        pa.paged_attention(args[0].float() if dtype != torch.float32
                           else args[0].bfloat16(), *args[1:], wpp=wpp)


def _strand(o, k, page, per, n=16):
    """Fill the heap with ``page``-byte pages, then free ``per`` pages in
    each of the first ``k`` chunks (partially full chunks, none free)."""
    dev = o.device
    st, live = o.init(), []
    sizes = torch.full((n,), page, dtype=torch.int32, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    while True:
        st, offs = o.alloc(st, sizes, ones)
        got = [x for x in offs.tolist() if x >= 0]
        if not got:
            break
        live += got
    by_chunk = {}
    for x in live:
        by_chunk.setdefault(x // o.cfg.words_per_chunk, []).append(x)
    drop = [x for c in sorted(by_chunk)[:k] for x in by_chunk[c][:per]]
    for i in range(0, len(drop), n):
        fo = torch.full((n,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + n])] = torch.tensor(drop[i:i + n],
                                               dtype=torch.int32)
        fo = fo.to(dev)
        st = o.free(st, fo, sizes, fo >= 0)
    return st


@pytest.mark.parametrize("cfgkw,page,k,per,max_moves", [
    (dict(total_bytes=1 << 15, chunk_bytes=1 << 11, min_page_bytes=64),
     64, 12, 20, 128),
    (dict(total_bytes=96 * 4096, chunk_bytes=4096, min_page_bytes=256),
     256, 60, 1, 128),
    # 64-B chunks: segment growth in the rebuild out of a dry pool
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     16, 40, 1, 1),
], ids=("test-defrag-cfg", "kv-geometry", "dry-pool-grow"))
def test_defrag_kernel_matches_plain_math_word_for_word(cuda, cfgkw, page, k,
                                                        per, max_moves):
    """The same stranded arena on the card and on the CPU: plans equal,
    then one ``defrag_txn`` launch leaves every word equal to
    ``migrate_math``'s; a second wave over the result as well."""
    o_gpu = Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device=cuda)
    o_cpu = Ouroboros(HeapConfig(**cfgkw), "vl_chunk", device="cpu")
    sg, sc = _strand(o_gpu, k, page, per), _strand(o_cpu, k, page, per)
    assert torch.equal(sg.mem.cpu(), sc.mem)
    ops.reset_launches()
    for wave in range(2):
        sg, fg = o_gpu.defrag(sg, max_moves=max_moves)
        sc, fc = o_cpu.defrag(sc, max_moves=max_moves)
        for a, b in zip(fg, fc):
            assert torch.equal(a.cpu(), b), wave
        torch.cuda.synchronize()
        assert torch.equal(sg.mem.cpu(), sc.mem), wave
        assert torch.equal(sg.ctl.cpu(), sc.ctl), wave
        if wave == 0:
            assert int((fc.src >= 0).sum()) > 0
    assert ops.LAUNCHES["defrag_txn"] == 2
    with pytest.raises(ValueError):
        from repro_torch.kernels import defrag_txn
        defrag_txn.arena_defrag_txn(o_gpu.cfg, "chunk", "vl", sg.mem,
                                    sg.ctl, fg.src[:-1], fg.dst, fg.sizes)


# a sharded arena of the engine's geometry: 4 shards x 12 chunks
SHARD_CFG = dict(total_bytes=4 * 12 * 4096, chunk_bytes=4096,
                 min_page_bytes=256)


@pytest.mark.parametrize("walk,hinting,n,n_ops", [
    (None, "hashed", 16, 30),
    (None, "pinned-array", 16, 40),   # every home on shard 0: exhausts it
    (1, "mixed", 32, 30),             # a bounded walk
    (None, "hashed", 4096, 6),        # 4096 lanes: every shard runs dry
], ids=("hashed", "exhausting-walk", "walk-1", "4096-lanes"))
def test_sharded_alloc_kernels_match_plain_replay_word_for_word(
        cuda, walk, hinting, n, n_ops):
    """Sharded alloc/free traces on the card and on the CPU: one
    ``sharded_alloc_txn`` / ``sharded_free_txn`` launch per transaction,
    offsets and words identical to the plain replay after every one,
    lanes served at walk attempts > 0."""
    kw = dict(num_shards=4, overflow_walk=walk)
    o_gpu = Ouroboros(HeapConfig(**SHARD_CFG), "vl_chunk", device=cuda, **kw)
    o_cpu = Ouroboros(HeapConfig(**SHARD_CFG), "vl_chunk", device="cpu",
                      **kw)
    sg, sc = o_gpu.init(), o_cpu.init()
    rng = np.random.default_rng(5)
    live = []
    ops.reset_launches()
    n_alloc = n_free = 0
    for step in range(n_ops):
        if live and step % 4 == 3:
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
            sc = o_cpu.free(sc, fo_t, fs_t, fo_t >= 0)
            sg = o_gpu.free(sg, fo_t.to(cuda), fs_t.to(cuda),
                            (fo_t >= 0).to(cuda))
            n_free += 1
        else:
            if hinting == "hashed":
                hint = None
            elif hinting == "pinned-array":
                hint = np.zeros(n, np.int32)
            else:
                hint = (rng.integers(-4, 8, n).astype(np.int32) if step % 2
                        else None)
            sizes = torch.from_numpy(
                rng.choice([256, 512, 1024, 4096, 8192], n,
                           p=[.6, .15, .1, .1, .05]).astype(np.int32))
            mask = torch.from_numpy(rng.random(n) < 0.9)
            sc, oc = o_cpu.alloc(sc, sizes, mask, shard_hint=hint)
            sg, og = o_gpu.alloc(
                sg, sizes.to(cuda), mask.to(cuda),
                shard_hint=None if hint is None
                else torch.from_numpy(hint).to(cuda))
            assert torch.equal(og.cpu(), oc), step
            live += [(a, b) for a, b in zip(oc.tolist(), sizes.tolist())
                     if a >= 0]
            n_alloc += 1
        assert torch.equal(sg.mem.cpu(), sc.mem), step
        assert torch.equal(sg.ctl.cpu(), sc.ctl), step
    assert ops.LAUNCHES["sharded_alloc_txn"] == n_alloc
    assert ops.LAUNCHES["sharded_free_txn"] == n_free
    lay = o_cpu.layout.shard
    bins = sc.ctl[:, lay.off_t_walk:lay.off_t_walk + 4].sum(0)
    fails = sc.ctl[:, lay.off_t_fail:lay.off_t_fail + lay.num_classes]
    if hinting != "hashed":
        assert int(bins[1:].sum()) > 0     # lanes served by neighbours
    if n == 4096:
        assert int(fails.sum()) > 0        # every shard ran dry


@pytest.mark.parametrize("chunk_bytes,page,max_moves,rounds", [
    (4096, 256, 128, 30),
    (64, 16, 4, 4),       # 15 queue ids a segment; pool claims
], ids=("kv-geometry", "tiny-chunks"))
def test_sharded_defrag_kernel_matches_plain_math_word_for_word(
        cuda, chunk_bytes, page, max_moves, rounds):
    """The same churned sharded arena on the card and on the CPU: a
    sharded compaction wave, then a cross-shard rebalance wave, one
    ``sharded_defrag_txn`` launch each, plans and words identical."""
    cfg = HeapConfig(total_bytes=4 * 12 * chunk_bytes,
                     chunk_bytes=chunk_bytes, min_page_bytes=page)
    outs = []
    for dev in (cuda, "cpu"):
        o = Ouroboros(cfg, "vl_chunk", device=dev, num_shards=4)
        rng = np.random.default_rng(3)
        n = 16
        sizes = torch.full((n,), page, dtype=torch.int32, device=dev)
        home = torch.zeros(n, dtype=torch.int32, device=dev)
        st, live = o.init(), []
        for _ in range(rounds):
            mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
            st, offs = o.alloc(st, sizes, mask, shard_hint=home)
            live += [x for x in offs.tolist() if x >= 0]
        drop = [x for i, x in enumerate(live) if i % 3]
        rng.shuffle(drop)
        for i in range(0, len(drop), n):
            fo = torch.full((n,), -1, dtype=torch.int32)
            fo[:len(drop[i:i + n])] = torch.tensor(drop[i:i + n],
                                                   dtype=torch.int32)
            fo = fo.to(dev)
            st = o.free(st, fo, sizes, fo >= 0)
        ops.reset_launches()
        st, f1 = o.defrag(st, max_moves=max_moves)
        st, f2 = o.rebalance(st, max_moves=max_moves)
        outs.append((st, f1, f2, dict(ops.LAUNCHES)))
    (sg, g1, g2, lg), (sc, c1, c2, _) = outs
    for a, b in zip(g1 + g2, c1 + c2):
        assert torch.equal(a.cpu(), b)
    torch.cuda.synchronize()
    assert torch.equal(sg.mem.cpu(), sc.mem)
    assert torch.equal(sg.ctl.cpu(), sc.ctl)
    assert int((c1.src >= 0).sum()) > 0 and int((c2.src >= 0).sum()) > 0
    assert lg["sharded_defrag_txn"] == 2 and lg["defrag_txn"] == 0


AUX_LANES = 298656   # mamba2-780m's aux pages per slot (one admission)


@pytest.mark.parametrize("num_shards", (1, 4), ids=("single", "sharded"))
def test_full_width_aux_transactions_match_plain_math(cuda, num_shards):
    """One admission's and one retirement's lanes of full-width
    mamba2-780m (298,656 pages of 256 B) on the engine's arena for 8
    slots: the kernels, whose lane tables go to a device workspace,
    against the plain math on a second arena on the card, offsets and
    words identical; one launch each."""
    from repro_torch.core import shards
    from repro_torch.core import transactions as T
    from repro_torch.paged.kv_cache import make_kv_allocator
    o, _, _ = make_kv_allocator(256 + 8 * AUX_LANES, device=cuda,
                                num_shards=num_shards)
    sk, sp = o.init(), o.init()
    n, S = AUX_LANES, num_shards
    sizes = torch.full((n,), 256, dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    base = (o.kind, o.family, sp.mem, sp.ctl)
    ops.reset_launches()
    _, offs = o.alloc(sk, sizes, mask)
    if S == 1:
        want = T.alloc_math(o.cfg, *base, sizes, mask)[2]
    else:
        home = shards.home_shards(n, S, None, device=cuda)
        want = T.sharded_alloc_math(o.cfg, S, *base, sizes, mask, home,
                                    o.walk)[2]
    assert bool((want >= 0).all())
    assert torch.equal(offs, want)
    assert torch.equal(sk.mem, sp.mem) and torch.equal(sk.ctl, sp.ctl)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    fo = want[perm.to(cuda)].contiguous()
    o.free(sk, fo, sizes, mask)
    if S == 1:
        T.free_math(o.cfg, *base, fo, sizes, mask)
    else:
        T.sharded_free_math(o.cfg, S, *base, fo, sizes, mask)
    torch.cuda.synchronize()
    assert torch.equal(sk.mem, sp.mem) and torch.equal(sk.ctl, sp.ctl)
    name = "alloc_txn" if S == 1 else "sharded_alloc_txn"
    assert ops.LAUNCHES[name] == 1
    assert ops.LAUNCHES[name.replace("alloc", "free")] == 1


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,chunks,with_h0", [(1, 1, False), (1, 4, False),
                                              (1, 7, False), (2, 3, True)])
def test_ssd_scan_kernel_matches_plain_at_full_width(cuda, dtype, B, chunks,
                                                     with_h0):
    """``ssd_scan`` at mamba2-780m's shapes (H 48, P 64, N 128, G 1,
    chunk 64; the engine's single-row prefill is B 1, 1-7 chunks)
    against ``ssd_plain`` on the same card tensors (bf16 widened to
    float32 by both): atol and rtol 1e-4."""
    from repro_torch.kernels import ssd_scan as ssd
    H, P, G, N, Q = 48, 64, 1, 128, 64
    L = Q * chunks
    rng = np.random.default_rng(chunks)
    x = torch.from_numpy(rng.standard_normal((B, L, H, P), np.float32))
    raw = rng.standard_normal((B, L, H)).astype(np.float32) - 3.0
    dt = torch.nn.functional.softplus(torch.from_numpy(raw))
    a = -torch.full((H,), 4.0)
    b = torch.from_numpy(rng.standard_normal((B, L, G, N), np.float32))
    c = torch.from_numpy(rng.standard_normal((B, L, G, N), np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((B, H, P, N), np.float32))
          .to(cuda) if with_h0 else None)
    x, b, c = (t.to(dtype).to(cuda) for t in (x, b, c))
    dt, a = dt.to(cuda), a.to(cuda)
    ops.reset_launches()
    y, hf = ops.ssd_scan(x, dt, a, b, c, h0, chunk=Q)
    wy, wh = ssd.ssd_plain(x, dt, a, b, c, Q, h0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hf, wh, atol=1e-4, rtol=1e-4)


def test_defrag_wave_on_the_mamba2_arena_matches_plain_math(cuda):
    """A wave on the mamba2-780m engine's arena (149,497 chunks, whose
    per-chunk tables go to a device workspace): one admission's grant,
    all but every fifth page freed, then ``defrag_txn`` against
    ``migrate_math`` on a copy of the same words on the card."""
    from repro_torch.core import defrag
    from repro_torch.core import transactions as T
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.kernels import defrag_txn as DT
    from repro_torch.paged.kv_cache import make_kv_allocator
    o, _, _ = make_kv_allocator(256 + 8 * AUX_LANES, device=cuda)
    d = AT.descriptor(o.layout)
    assert DT._lib().defrag_txn_workspace_bytes(d, AT.TABLE_SMEM_LIMIT) > 0
    st = o.init()
    n = AUX_LANES
    sizes = torch.full((n,), 256, dtype=torch.int32, device=cuda)
    st, offs = o.alloc(st, sizes, torch.ones(n, dtype=torch.bool,
                                             device=cuda))
    keep = torch.arange(n, device=cuda) % 5 == 0
    fo = torch.where(keep, torch.full_like(offs, -1), offs)
    st = o.free(st, fo, sizes, fo >= 0)
    plan = defrag.plan_math(o.cfg, o.kind, o.family, st.mem, st.ctl,
                            max_moves=o._moves(None))
    assert int((plan[0] >= 0).sum()) > 0
    mem, ctl = st.mem.clone(), st.ctl.clone()
    ops.reset_launches()
    T.migrate(o.cfg, o.kind, o.family, st, *plan)
    defrag.migrate_math(o.cfg, o.kind, o.family, mem, ctl, *plan)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["defrag_txn"] == 1
    assert torch.equal(st.mem, mem) and torch.equal(st.ctl, ctl)


# ---- the piecewise allocator's steps and API --------------------------------

PIECEWISE = ("ring_txn_pop", "ring_txn_push", "chunk_txn_claim",
             "ring_window", "bitmap_select")


@pytest.mark.parametrize("n,C,cap,base", [
    (16, 3, 48, 0), (4096, 5, 10944, -2 ** 31 + 7),
    (4096, 5, 1000, 2 ** 31 - 300)],
    ids=("16-lanes", "4096-lanes-wrapped", "4096-lanes-crossing"))
def test_ring_kernels_match_plain_on_the_card(cuda, n, C, cap, base):
    """``ring_txn_pop`` (both grants), ``ring_txn_push`` and
    ``ring_window`` against their plain versions on the same tensors of
    the card: multi-tile ranks, counters past 2^31, masked lanes and
    lanes of an out-of-range class; one launch each."""
    rng = np.random.default_rng(n + cap)
    store = torch.from_numpy(rng.integers(0, 10 ** 6, (C, cap))
                             .astype(np.int32)).to(cuda)
    front = base + rng.integers(0, 3 * cap, C)
    back = front + rng.integers(0, cap + 1, C)
    front, back = (torch.from_numpy(x.astype(np.int32)).to(cuda)
                   for x in (front, back))
    cls = torch.from_numpy(rng.integers(-1, C + 1, n).astype(np.int32)
                           ).to(cuda)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 10 ** 6, n).astype(np.int32)
                            ).to(cuda)
    ops.reset_launches()
    for limit in (True, False):
        got = ops.ring_txn_pop(store, front, back, cls, valid, limit=limit)
        want = ref.ring_txn_pop_ref(store, front, back, cls, valid, limit)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), limit
    gs, gb = ops.ring_txn_push(store.clone(), back, cls, vals, valid)
    ws, wb = ref.ring_txn_push_ref(store.clone(), back, cls, vals, valid)
    assert torch.equal(gs, ws) and torch.equal(gb, wb)
    m = min(cap, 4096)
    counts = torch.from_numpy(rng.integers(0, m + 1, C).astype(np.int32)
                              ).to(cuda)
    assert torch.equal(ops.ring_window(store, front, counts, m=m),
                       ref.ring_window_ref(store, front, counts, m))
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] for k in PIECEWISE[:2] + ("ring_window",)} \
        == {"ring_txn_pop": 2, "ring_txn_push": 1, "ring_window": 1}


@pytest.mark.parametrize("bw,ppc,W", [(1, 16, 32), (4, 128, 4128),
                                      (1100, 1100 * 32 - 5, 1056)])
def test_bitmap_kernels_match_plain_on_the_card(cuda, bw, ppc, W):
    """``chunk_txn_claim`` (takes 0, a few, all, past the free bits) and
    ``bitmap_select`` / ``bitmap_select_indices`` (k 0, 1, 4096, past
    the set bits; several tiles of 1024 words) against their plain
    versions on the card."""
    rng = np.random.default_rng(bw + W)
    row = torch.from_numpy(rng.integers(0, 2 ** 32, bw, dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(cuda)
    for take in (0, 3, ppc, 10 ** 6):
        got = ops.chunk_txn_claim(row, take, ppc=ppc)
        want = ref.chunk_txn_claim_ref(row, take, ppc)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), take
    words = torch.from_numpy(rng.integers(0, 2 ** 32, W, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(cuda)
    for k in (0, 1, 4096, 10 ** 9):
        assert torch.equal(ops.bitmap_select(words, k),
                           ref.bitmap_select_ref(words, k)), k
        gi, gv = ops.bitmap_select_indices(words, k, max_k=4096)
        wi, wv = ops.bitmap_select_indices(words.cpu(), k, max_k=4096)
        assert torch.equal(gi.cpu(), wi) and torch.equal(gv.cpu(), wv), k


@pytest.mark.parametrize("kind,family", [
    (k, f) for k in ("page", "chunk") for f in ("ring", "va", "vl")],
    ids=[f"{f}_{k}" for k in ("page", "chunk") for f in ("ring", "va", "vl")])
def test_piecewise_traces_match_plain_on_the_card(cuda, kind, family):
    """The piecewise API of one variant on the card (its steps through
    the five kernels) against the plain route on the CPU: offsets and
    arena words after every transaction (and, for chunk kinds, after
    ``compact``), 16-lane traces of mixed sizes; the kernels launched
    and the fused transaction kernels not."""
    from repro_torch.core import arena, chunk_alloc, page_alloc
    cfg = HeapConfig(total_bytes=1 << 16, chunk_bytes=1 << 11,
                     min_page_bytes=16)
    mod = page_alloc if kind == "page" else chunk_alloc
    lay = arena.layout(cfg, kind, family)
    arenas, views = [], []
    ops.reset_launches()
    for dev, pw in ((cuda, True), ("cpu", False)):
        st = arena.blank(lay, dev)
        v = page_alloc.AllocState(*arena.unpack(lay, st))
        mod.init(cfg, family, v, piecewise=pw)
        arenas.append(st)
        views.append(v)
    rng = np.random.default_rng(3)
    live = []
    for step in range(24):
        if live and step % 3 == 2:
            k = min(len(live), 16)
            fo = np.full(16, -1, np.int32)
            fs = np.zeros(16, np.int32)
            fo[:k] = [o for o, _ in live[:k]]
            fs[:k] = [s for _, s in live[:k]]
            live = live[k:]
            for (dev, pw), v in zip(((cuda, True), ("cpu", False)), views):
                t = torch.from_numpy(fo).to(dev)
                mod.free(cfg, family, v, t, torch.from_numpy(fs).to(dev),
                         t >= 0, piecewise=pw)
        else:
            sizes = rng.choice([16, 24, 64, 100, 256, 1000, 2048, 4096], 16
                               ).astype(np.int32)
            mask = rng.random(16) < 0.9
            outs = [mod.alloc(cfg, family, v, torch.from_numpy(sizes).to(dev),
                              torch.from_numpy(mask).to(dev),
                              piecewise=pw)[1].cpu()
                    for (dev, pw), v in zip(((cuda, True), ("cpu", False)),
                                            views)]
            assert torch.equal(*outs), step
            live += [(o, s) for o, s in zip(outs[1].tolist(), sizes.tolist())
                     if o >= 0]
        assert torch.equal(arenas[0].mem.cpu(), arenas[1].mem), step
        assert torch.equal(arenas[0].ctl.cpu(), arenas[1].ctl), step
    if kind == "chunk":
        chunk_alloc.compact(cfg, family, views[0], piecewise=True)
        chunk_alloc.compact(cfg, family, views[1])
        assert torch.equal(arenas[0].mem.cpu(), arenas[1].mem)
        assert torch.equal(arenas[0].ctl.cpu(), arenas[1].ctl)
    torch.cuda.synchronize()
    used = {"ring_txn_pop", "ring_txn_push"}
    if kind == "chunk":
        used |= {"chunk_txn_claim", "bitmap_select"}
    if family == "va":
        used.add("ring_window")
    assert all(ops.LAUNCHES[k] > 0 for k in used), ops.LAUNCHES
    assert ops.LAUNCHES["alloc_txn"] == ops.LAUNCHES["free_txn"] == 0


# ---- the other five variants through the fused transactions and waves -----

OTHER_VARIANTS = ("page", "chunk", "va_page", "vl_page", "va_chunk")
VARIANT_CFG = dict(total_bytes=1 << 16, chunk_bytes=1 << 11,
                   min_page_bytes=16)
TINY = dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16)


def _past_2_31(st, lay, past=3):
    """Each class queue's counters, and the pool's, moved so that the
    back lies ``past`` slots below 2^31 (counts kept)."""
    C = lay.num_classes
    ctl = st.ctl.cpu().to(torch.int64)
    pairs = [(lay.off_front + c, lay.off_back + c) for c in range(C)]
    for f, b in pairs + [(lay.off_pool_front, lay.off_pool_back)]:
        dlt = 2 ** 31 - past - int(ctl[b])
        ctl[f] += dlt
        ctl[b] += dlt
    st.ctl.copy_(ctl.to(torch.int32))
    return st


def _card_trace(cuda, variant, cfgkw, menu, n, n_ops, bias, seed,
                num_shards=1, hints=None, shift=False):
    """One seeded alloc/free trace on the card and on the CPU: one
    transaction kernel launch each on the card, offsets and words equal
    to the plain math after every one.  Returns the CPU arena and the
    failed lanes."""
    kw = {"num_shards": num_shards} if num_shards > 1 else {}
    o_gpu = Ouroboros(HeapConfig(**cfgkw), variant, device=cuda, **kw)
    o_cpu = Ouroboros(HeapConfig(**cfgkw), variant, device="cpu", **kw)
    sg, sc = o_gpu.init(), o_cpu.init()
    if shift:
        _past_2_31(sc, o_cpu.layout)
        sg.ctl.copy_(sc.ctl.to(cuda))
    assert torch.equal(sg.mem.cpu(), sc.mem)
    rng = np.random.default_rng(seed)
    live, failed, counts = [], 0, {"alloc": 0, "free": 0}
    ops.reset_launches()
    for step in range(n_ops):
        if not live or rng.random() < bias:
            sizes = torch.from_numpy(rng.choice(menu, n).astype(np.int32))
            mask = torch.from_numpy(rng.random(n) < 0.85)
            hint = None if hints is None else hints(rng, step)
            hk = {} if hint is None else {"shard_hint": hint}
            sc, oc = o_cpu.alloc(sc, sizes, mask, **hk)
            if hint is not None:
                hk = {"shard_hint": torch.from_numpy(hint).to(cuda)}
            sg, og = o_gpu.alloc(sg, sizes.to(cuda), mask.to(cuda), **hk)
            assert torch.equal(og.cpu(), oc), step
            failed += int(((oc < 0) & mask).sum())
            live += [(int(a), int(b)) for a, b in
                     zip(oc.tolist(), sizes.tolist()) if a >= 0]
            counts["alloc"] += 1
        else:
            k = min(len(live), int(rng.integers(1, n + 1)))
            pick = set(rng.choice(len(live), k, replace=False).tolist())
            fo = np.full(n, -1, np.int32)
            fs = np.zeros(n, np.int32)
            drop = [x for i, x in enumerate(live) if i in pick]
            live = [x for i, x in enumerate(live) if i not in pick]
            fo[:k] = [a for a, _ in drop]
            fs[:k] = [b for _, b in drop]
            perm = rng.permutation(n)
            fo_t = torch.from_numpy(fo[perm].copy())
            fs_t = torch.from_numpy(fs[perm].copy())
            sc = o_cpu.free(sc, fo_t, fs_t, fo_t >= 0)
            sg = o_gpu.free(sg, fo_t.to(cuda), fs_t.to(cuda),
                            (fo_t >= 0).to(cuda))
            counts["free"] += 1
        assert torch.equal(sg.mem.cpu(), sc.mem), step
        assert torch.equal(sg.ctl.cpu(), sc.ctl), step
    pre = "sharded_" if num_shards > 1 else ""
    assert ops.LAUNCHES[pre + "alloc_txn"] == counts["alloc"]
    assert ops.LAUNCHES[pre + "free_txn"] == counts["free"]
    return o_cpu, sc, failed


@pytest.mark.parametrize("case", ("mixed", "4096-lanes", "exhausting",
                                  "past-2^31"))
@pytest.mark.parametrize("variant", OTHER_VARIANTS)
def test_variant_transactions_match_plain_math_on_the_card(cuda, variant,
                                                           case):
    """``alloc_txn``/``free_txn`` of the other five variants against the
    plain math on the CPU: mixed classes at 32 lanes and at 4096 (every
    class inventory drained), an exhausted tiny heap, and counters
    carried past 2^31."""
    if case == "mixed":
        _card_trace(cuda, variant, VARIANT_CFG,
                    [16, 24, 100, 256, 1000, 2048, 8192], 32, 30, 0.7, 0)
    elif case == "4096-lanes":
        _card_trace(cuda, variant, VARIANT_CFG, [16, 24, 100, 256, 1000],
                    4096, 6, 0.6, 1)
    elif case == "exhausting":
        _, _, failed = _card_trace(cuda, variant, TINY, [16, 32, 64], 64, 40,
                                   0.8, 7)
        assert failed > 0
    else:
        _, sc, _ = _card_trace(cuda, variant, VARIANT_CFG, [16, 16, 32, 64],
                               64, 12, 0.7, 8, shift=True)
        assert int(sc.ctl[:16].min()) < 0


@pytest.mark.parametrize("variant", OTHER_VARIANTS)
def test_variant_sharded_transactions_match_plain_replay_on_the_card(
        cuda, variant):
    """``sharded_alloc_txn``/``sharded_free_txn`` of the other five
    variants on 4 shards (homes hashed, pinned to shard 0, hinted per
    lane), against the plain replay, with lanes served at walk attempts
    > 0."""
    o, sc, _ = _card_trace(
        cuda, variant, SHARD_CFG, [256, 512, 1024, 4096, 8192], 32, 30, 0.75,
        5, num_shards=4,
        hints=lambda rng, i: (None, np.zeros(32, np.int32),
                              rng.integers(-4, 8, 32).astype(np.int32))[i % 3])
    lay = o.layout.shard
    assert int(sc.ctl[:, lay.off_t_walk + 1:lay.off_t_walk + 4].sum()) > 0


@pytest.mark.parametrize("variant", ("chunk", "va_chunk"))
def test_ring_and_va_waves_match_plain_math_on_the_card(cuda, variant):
    """The ring and va rebuilds on the card: a churned arena's defrag
    wave (``defrag_txn``), then a 4-shard arena's compaction and
    rebalance waves (``sharded_defrag_txn``), plans and words identical
    to the plain math on the CPU."""
    for S in (1, 4):
        cfg = HeapConfig(total_bytes=(30 if S == 1 else 48) * 4096,
                         chunk_bytes=4096, min_page_bytes=256)
        outs = []
        for dev in (cuda, "cpu"):
            o = Ouroboros(cfg, variant, device=dev,
                          **({"num_shards": S} if S > 1 else {}))
            rng = np.random.default_rng(3)
            n = 16
            sizes = torch.full((n,), 256, dtype=torch.int32, device=dev)
            hint = ({"shard_hint": torch.zeros(n, dtype=torch.int32,
                                               device=dev)} if S > 1 else {})
            st, live = o.init(), []
            for _ in range(20 if S == 1 else 6):
                mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
                st, offs = o.alloc(st, sizes, mask, **hint)
                live += [x for x in offs.tolist() if x >= 0]
            drop = [x for i, x in enumerate(live) if i % 3]
            rng.shuffle(drop)
            for i in range(0, len(drop), n):
                fo = torch.full((n,), -1, dtype=torch.int32)
                fo[:len(drop[i:i + n])] = torch.tensor(drop[i:i + n],
                                                       dtype=torch.int32)
                fo = fo.to(dev)
                st = o.free(st, fo, sizes, fo >= 0)
            ops.reset_launches()
            st, f1 = o.defrag(st)
            fwd = list(f1)
            if S > 1:
                st, f2 = o.rebalance(st)
                fwd += list(f2)
            outs.append((st, fwd, dict(ops.LAUNCHES)))
        (sg, gf, lg), (sc, cf, _) = outs
        for a, b in zip(gf, cf):
            assert torch.equal(a.cpu(), b)
        torch.cuda.synchronize()
        assert torch.equal(sg.mem.cpu(), sc.mem)
        assert torch.equal(sg.ctl.cpu(), sc.ctl)
        assert int((cf[0] >= 0).sum()) > 0
        want = {"defrag_txn": 1} if S == 1 else {"sharded_defrag_txn": 2}
        assert {k: lg[k] for k in want} == want
