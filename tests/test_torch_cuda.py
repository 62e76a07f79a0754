"""The port's CUDA kernels held to their plain versions on the card, the
fused decode mega-step held to the host loop there (tokens, launches a
tick, one synchronizing call a steady tick), and snapshot/restore of
the serving state on the card and between the card and the CPU.

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
from repro_torch.models.transformer import num_attn_layers

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
    (None, "pinned-array", 64, 24),   # attempt launches, shards run dry
    (None, "hashed", 4096, 6),        # 4096 lanes: every shard runs dry
], ids=("hashed", "exhausting-walk", "walk-1", "64-lanes-attempts",
        "4096-lanes"))
def test_sharded_alloc_kernels_match_plain_replay_word_for_word(
        cuda, walk, hinting, n, n_ops):
    """Sharded alloc/free traces on the card and on the CPU: one
    ``sharded_alloc_txn`` / ``sharded_free_txn`` call per transaction
    (one block for 32 lanes or fewer; above, the partition over the card
    and an attempt a launch of 4 blocks, as the kernels counted their
    launches), offsets and words identical to the plain replay after
    every one, lanes served at walk attempts > 0; the kernels count every
    transaction, none on per-step lists."""
    from repro_torch.kernels import alloc_txn as AT
    kw = dict(num_shards=4, overflow_walk=walk)
    o_gpu = Ouroboros(HeapConfig(**SHARD_CFG), "vl_chunk", device=cuda, **kw)
    o_cpu = Ouroboros(HeapConfig(**SHARD_CFG), "vl_chunk", device="cpu",
                      **kw)
    sg, sc = o_gpu.init(), o_cpu.init()
    rng = np.random.default_rng(5)
    live = []
    ops.reset_launches()
    AT.shard_stats(reset=True)
    AT.launch_stats(reset=True)
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
    steps = AT.shard_stats(reset=True)
    assert steps["transactions"] == n_alloc and steps["rescans"] == 0
    ran = AT.launch_stats(reset=True)
    grid = n > 32
    assert ran == dict(
        alloc_txn=0, free_txn=0, free_lanes=0,
        sharded_alloc_txn=0 if grid else n_alloc,
        sharded_alloc_count=n_alloc if grid else 0,
        sharded_alloc_place=n_alloc if grid else 0,
        sharded_alloc_attempt=n_alloc * (o_gpu.walk + 1) if grid else 0,
        sharded_free_txn=n_free), ran
    lay = o_cpu.layout.shard
    bins = sc.ctl[:, lay.off_t_walk:lay.off_t_walk + 4].sum(0)
    fails = sc.ctl[:, lay.off_t_fail:lay.off_t_fail + lay.num_classes]
    if hinting != "hashed":
        assert int(bins[1:].sum()) > 0     # lanes served by neighbours
    if n == 4096:
        assert int(fails.sum()) > 0        # every shard ran dry


@pytest.mark.parametrize("n", (16, 64))
def test_sharded_alloc_past_31_shards_matches_plain_replay(cuda, n):
    """33 shards of 6 chunks, walk 2: every transaction takes per-step
    lists (the warp-sized block, or one attempt launch of one block, as
    the kernels counted them), offsets and words identical to the plain
    replay after each of 8 allocs that exhaust shards."""
    from repro_torch.kernels import alloc_txn as AT
    S = 33
    cfg = HeapConfig(total_bytes=S * 6 * 4096, chunk_bytes=4096,
                     min_page_bytes=256)
    kw = dict(num_shards=S, overflow_walk=2)
    o_gpu = Ouroboros(cfg, "vl_chunk", device=cuda, **kw)
    o_cpu = Ouroboros(cfg, "vl_chunk", device="cpu", **kw)
    sg, sc = o_gpu.init(), o_cpu.init()
    rng = np.random.default_rng(8)
    AT.shard_stats(reset=True)
    AT.launch_stats(reset=True)
    for step in range(8):
        hint = rng.integers(0, 3, n).astype(np.int32)
        sizes = torch.from_numpy(rng.choice([256, 1024, 4096], n)
                                 .astype(np.int32))
        mask = torch.from_numpy(rng.random(n) < 0.9)
        sc, oc = o_cpu.alloc(sc, sizes, mask, shard_hint=hint)
        sg, og = o_gpu.alloc(sg, sizes.to(cuda), mask.to(cuda),
                             shard_hint=torch.from_numpy(hint).to(cuda))
        assert torch.equal(og.cpu(), oc), step
        assert torch.equal(sg.mem.cpu(), sc.mem), step
        assert torch.equal(sg.ctl.cpu(), sc.ctl), step
    assert AT.shard_stats(reset=True)["rescans"] == 8
    ran = {k: v for k, v in AT.launch_stats(reset=True).items() if v}
    assert ran == ({"sharded_alloc_attempt": 8} if n > 32
                   else {"sharded_alloc_txn": 8}), ran


@pytest.mark.parametrize("chunk_bytes,page,max_moves,rounds", [
    (4096, 256, 128, 30),
    (64, 16, 4, 4),       # 15 queue ids a segment; pool claims
], ids=("kv-geometry", "tiny-chunks"))
def test_sharded_defrag_kernel_matches_plain_math_word_for_word(
        cuda, chunk_bytes, page, max_moves, rounds):
    """The same churned sharded arena on the card and on the CPU: a
    sharded compaction wave, then a cross-shard rebalance wave, one
    ``sharded_defrag_txn`` call each (the extract grid, then 4 rebuild
    blocks), plans and words identical; 8 rebuilds, each on the path the
    kernel counts (parallel unless the pool runs dry)."""
    from repro_torch.kernels import defrag_txn as DT
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
        if dev != "cpu":
            DT.rebuild_stats(reset=True)
        st, f1 = o.defrag(st, max_moves=max_moves)
        st, f2 = o.rebalance(st, max_moves=max_moves)
        if dev != "cpu":
            rebuilt = DT.rebuild_stats(reset=True)
        outs.append((st, f1, f2, dict(ops.LAUNCHES)))
    (sg, g1, g2, lg), (sc, c1, c2, _) = outs
    for a, b in zip(g1 + g2, c1 + c2):
        assert torch.equal(a.cpu(), b)
    torch.cuda.synchronize()
    assert torch.equal(sg.mem.cpu(), sc.mem)
    assert torch.equal(sg.ctl.cpu(), sc.ctl)
    assert int((c1.src >= 0).sum()) > 0 and int((c2.src >= 0).sum()) > 0
    assert lg["sharded_defrag_txn"] == 2 and lg["defrag_txn"] == 0
    assert rebuilt["parallel_rebuilds"] + rebuilt["serial_rebuilds"] == 8
    assert rebuilt["parallel_values"] + rebuilt["serial_values"] > 0


AUX_LANES = 298656   # mamba2-780m's aux pages per slot (one admission)


@pytest.mark.parametrize("num_shards", (1, 4), ids=("single", "sharded"))
def test_full_width_aux_transactions_match_plain_math(cuda, num_shards):
    """One admission's and one retirement's lanes of full-width
    mamba2-780m (298,656 pages of 256 B) on the engine's arena for 8
    slots: the kernels, whose lane tables go to a device workspace,
    against the plain math on a second arena on the card, offsets and
    words identical; one wrapper call each; the retirement's revived
    chunks written by the parallel enqueue (the kernel's own count)."""
    from repro_torch.core import shards
    from repro_torch.core import transactions as T
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.paged.kv_cache import make_kv_allocator
    o, _, _ = make_kv_allocator(256 + 8 * AUX_LANES, device=cuda,
                                num_shards=num_shards)
    sk, sp = o.init(), o.init()
    n, S = AUX_LANES, num_shards
    sizes = torch.full((n,), 256, dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    base = (o.kind, o.family, sp.mem, sp.ctl)
    ops.reset_launches()
    AT.shard_stats(reset=True)
    _, offs = o.alloc(sk, sizes, mask)
    steps = AT.shard_stats(reset=True)
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
    # the chunks the retirement revives: touched by it and full
    lay = o.layout if S == 1 else o.layout.shard
    nc, wpc, ws = (lay.cfg.num_chunks, lay.cfg.words_per_chunk,
                   lay.cfg.total_words)
    off = lay.region("free_count").offset
    fc = sk.mem.reshape(S, -1)[:, off:off + nc].reshape(-1)
    g = fo.long()
    revived = int((fc[((g // ws) * nc + (g % ws) // wpc).unique()] == 0)
                  .sum())
    AT.enqueue_stats(reset=True)
    o.free(sk, fo, sizes, mask)
    freed = AT.enqueue_stats(reset=True)
    if S == 1:
        T.free_math(o.cfg, *base, fo, sizes, mask)
    else:
        T.sharded_free_math(o.cfg, S, *base, fo, sizes, mask)
    torch.cuda.synchronize()
    assert torch.equal(sk.mem, sp.mem) and torch.equal(sk.ctl, sp.ctl)
    name = "alloc_txn" if S == 1 else "sharded_alloc_txn"
    assert ops.LAUNCHES[name] == 1
    if S > 1:   # every bucket served on its home shard: S steps, no walk
        assert steps == dict(transactions=1, steps=S, step_lanes=n,
                             rescans=0)
    assert ops.LAUNCHES[name.replace("alloc", "free")] == 1
    # the revived chunks go back to their queue in parallel: one enqueue
    # a block, none in lane order
    assert revived > 18000
    assert freed == dict(parallel_enqueues=S, parallel_values=revived,
                         serial_enqueues=0, serial_values=0)


def _rotate_pool(o, st, front_slot):
    """The same pool (ids in the same order) moved round its ring so
    that its front sits at slot ``front_slot``."""
    lay, nc = o.layout, o.cfg.num_chunks
    r = lay.region("pool_store")
    slots = st.mem[r.offset:r.offset + nc]
    pf, pb = (int(st.ctl[lay.off_pool_front]), int(st.ctl[lay.off_pool_back]))
    ids = slots[torch.arange(pf, pb, device=slots.device) % nc].clone()
    shift = (front_slot - pf) % nc
    slots[torch.arange(pf + shift, pb + shift, device=slots.device) % nc] = ids
    st.ctl[lay.off_pool_front] = pf + shift
    st.ctl[lay.off_pool_back] = pb + shift
    return st


@pytest.mark.parametrize("scenario", ("drain-and-wrap", "exhausted",
                                      "requeued"))
def test_full_width_chunk_runs_match_plain_math(cuda, scenario):
    """A 298,656-lane grant (one mamba2-780m admission) whose chain first
    drains a class queue of partially used chunks and then runs over
    fresh pool chunks across the end of the pool's ring
    (``drain-and-wrap``), runs out of pool halfway (``exhausted``, an
    arena of 150,000 pages), or takes a retired admission's 18,666
    chunks back from the class queue by dequeue runs (``requeued``):
    offsets and words equal the plain math's on a second arena on the
    card; the kernel's own count of what its chain took (one whole-chunk
    run, or one dequeue run of every queued chunk) agrees."""
    from repro_torch.core import transactions as T
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.paged.kv_cache import make_kv_allocator
    n = AUX_LANES
    o, _, _ = make_kv_allocator(256 + 8 * n if scenario != "exhausted"
                                else 150_000, device=cuda)
    sk = o.init()
    if scenario == "drain-and-wrap":
        sk = _rotate_pool(o, sk, o.cfg.num_chunks - 1000)
    sp = type(sk)(sk.mem.clone(), sk.ctl.clone())
    base = (o.kind, o.family, sp.mem, sp.ctl)

    def alloc(lanes):
        sizes = torch.full((lanes,), 256, dtype=torch.int32, device=cuda)
        mask = torch.ones(lanes, dtype=torch.bool, device=cuda)
        _, offs = o.alloc(sk, sizes, mask)
        want = T.alloc_math(o.cfg, *base, sizes, mask)[2]
        assert torch.equal(offs, want)
        assert torch.equal(sk.mem, sp.mem) and torch.equal(sk.ctl, sp.ctl)
        return want

    if scenario == "requeued":
        got = alloc(n)
        fo = got[torch.randperm(n, device=cuda)].contiguous()
        sizes = torch.full_like(fo, 256)
        mask = torch.ones_like(fo, dtype=torch.bool)
        o.free(sk, fo, sizes, mask)
        T.free_math(o.cfg, *base, fo, sizes, mask)
        assert torch.equal(sk.mem, sp.mem) and torch.equal(sk.ctl, sp.ctl)
        assert int(sk.ctl[o.layout.off_back] - sk.ctl[o.layout.off_front]) \
            == n // 16
    if scenario == "drain-and-wrap":
        got = alloc(40)            # two full chunks and a partial one
        fo = got[::3].contiguous()
        sizes = torch.full_like(fo, 256)
        mask = torch.ones_like(fo, dtype=torch.bool)
        o.free(sk, fo, sizes, mask)
        T.free_math(o.cfg, *base, fo, sizes, mask)
        assert torch.equal(sk.mem, sp.mem) and torch.equal(sk.ctl, sp.ctl)
    lay = o.layout
    pf0 = int(sk.ctl[lay.off_pool_front])
    ops.reset_launches()
    AT.chain_stats(reset=True)
    got = alloc(n)
    took = AT.chain_stats()
    assert ops.LAUNCHES["alloc_txn"] == 1
    ran = int(sk.ctl[lay.off_pool_front]) - pf0
    if scenario == "exhausted":
        assert int(sk.ctl[lay.off_pool_back]) == pf0 + ran
        assert 0 < int((got >= 0).sum()) < n
        assert (took["whole_runs"], took["whole_chunks"]) == (1, ran)
    elif scenario == "requeued":       # the queue served it all
        assert ran == 0 and bool((got >= 0).all())
        assert (took["dequeue_tries"], took["dequeue_chunks"],
                took["serial_steps"]) == (1, n // 16, 0)
    else:
        assert ran > 1000 and bool((got >= 0).all())
        assert took["whole_runs"] == 1
        assert took["whole_chunks"] in (ran - 1, ran)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_splits_at_serving_shapes(cuda, dtype, wpp):
    """B 8 x P 32 of 16-token pages (8 splits of 4 pages a sequence and
    kv head): lengths 0, 1, one split's exact multiple, P * page and
    ragged ones, a hole inside a live split, a split of holes, holes
    past the live range; atol 1e-5 of the plain version, one counted
    launch, every output of a zero-length row 0."""
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(2)
    B, Hq, Hkv, D, page, P, NP = 8, 14, 2, 64, 16, 32, 300
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[4, 2] = -1            # inside a live split
    table[3, 4:8] = -1          # a whole split of holes
    table[5, 3:] = -1           # past the live range
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    seq = np.array([0, 1, 64, 512, 100, 37, 300, 511], np.int32)
    args = [x.to(dtype).to(cuda) for x in (q, k, v)] + [
        torch.from_numpy(table).to(cuda), torch.from_numpy(seq).to(cuda)]
    assert pa.geometry(page, P) == (4, 8)
    ops.reset_launches()
    got = ops.paged_attention(*args, wpp=wpp)
    want = ref.paged_attention(*args, wpp=wpp)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    assert float((got - want).abs().max()) <= 1e-5
    assert not bool(got[0].any())


# (B, Hq, Hkv, D, page, P, NP, seq_lens, window, ring, holes as (row,
# first slot, last slot + 1)): the emulated test's window and ring
# cases, then mixtral-8x7b's decode shapes (a 512-slot table and a
# 258-slot ring, lengths on both sides of the 4096-token window)
WINDOW_CASES = {
    "mixtral-heads-window": (6, 8, 2, 128, 16, 16, 200,
                             [0, 64, 100, 160, 161, 224], 96, False,
                             [(3, 0, 4), (4, 7, 8), (5, 2, 9)]),
    "mixtral-heads-ring": (6, 8, 2, 128, 16, 10, 120,
                           [16, 159, 160, 161, 1000, 4097], 128,
                           True, [(3, 4, 5), (5, 0, 2)]),
    "ring-no-window": (4, 8, 2, 64, 16, 6, 40, [0, 70, 96, 333], None, True,
                       [(3, 1, 2)]),
    "narrow-ring-window": (3, 4, 1, 12, 8, 5, 30, [7, 41, 200], 20, True,
                           [(2, 3, 4)]),
    "mixtral-window": (8, 32, 8, 128, 16, 512, 4160,
                       [1, 100, 4096, 4097, 4160, 5000, 8000, 8192], 4096,
                       False, [(1, 3, 4), (5, 260, 262), (7, 0, 5)]),
    "mixtral-ring": (8, 32, 8, 128, 16, 258, 2100,
                     [1, 100, 4096, 4097, 4160, 5000, 8000, 8192], 4096,
                     True, [(1, 3, 4), (5, 254, 256), (6, 257, 258)]),
    # recurrentgemma-9b's heads (G 16 on one kv head of 256): the
    # emulated test's cases, then its decode shapes as served (max_seq
    # 4,192: a 262-slot table) and on a 130-slot ring, lengths on both
    # sides of the 2,048-token window
    "hybrid-heads-window": (4, 16, 1, 256, 16, 12, 50, [0, 100, 161, 190],
                            96, False, [(2, 3, 5), (3, 0, 4)]),
    "hybrid-heads-ring": (4, 16, 1, 256, 16, 10, 60, [16, 160, 161, 1000],
                          128, True, [(3, 4, 5), (1, 9, 10)]),
    "hybrid-recurrentgemma-window": (8, 16, 1, 256, 16, 262, 2160,
                              [1, 100, 2048, 2049, 2100, 3000, 4160, 4192],
                              2048, False,
                              [(1, 3, 4), (5, 130, 132), (7, 0, 5)]),
    "hybrid-recurrentgemma-ring": (8, 16, 1, 256, 16, 130, 1100,
                            [1, 100, 2048, 2049, 2100, 3000, 4160, 4192],
                            2048, True,
                            [(1, 3, 4), (5, 70, 72), (6, 129, 130)]),
}


@pytest.mark.parametrize("case", tuple(WINDOW_CASES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_window_and_ring_match_plain(cuda, case, dtype,
                                                     wpp):
    """``window`` and ``ring`` on the card: windows whose edges fall on
    split boundaries and inside pages, ring tables shorter than the
    sequence, holes, both table modes and dtypes; atol 1e-5 of the plain
    version, one counted launch, and the window changes the result."""
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
    args = [x.to(dtype).to(cuda) for x in (q, k, v)] + [
        torch.from_numpy(table).to(cuda),
        torch.tensor(seq, dtype=torch.int32, device=cuda)]
    kw = dict(wpp=wpp, window=window, ring=ring)
    ops.reset_launches()
    got = ops.paged_attention(*args, **kw)
    want = ref.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    assert float((got - want).abs().max()) <= 1e-5
    assert not bool(got[args[4] == 0].any())
    plain = ref.paged_attention(*args, wpp=wpp)
    assert float((plain - want).abs().max()) > 1e-3


# (B, Hq, Hkv, D, page, P, NP, seq_lens, window, ring, holes): int8
# pages at the emulated test's head shapes (G 1, 4, 7; D 24-128), then
# qwen1.5-32b's decode shapes (40 query and 40 kv heads of 128, a 64-slot
# table, lengths 1-1,024) and mixtral-8x7b's window and ring in int8
INT8_CASES = {
    "g1-d128": (3, 2, 2, 128, 16, 5, 24, [0, 37, 80], None, False,
                [(2, 1, 2)]),
    "g4-d64": (4, 8, 2, 64, 16, 6, 40, [96, 1, 50, 70], None, False,
               [(0, 2, 3), (3, 4, 6)]),
    "g7-d32": (3, 14, 2, 32, 16, 5, 30, [80, 17, 64], None, False,
               [(1, 0, 1)]),
    "narrow-rows": (2, 2, 1, 24, 8, 5, 20, [33, 7], None, False,
                    [(0, 3, 4)]),
    "qwen1.5-32b": (8, 40, 40, 128, 16, 64, 560,
                    [1, 17, 64, 255, 448, 600, 1000, 1024], None, False,
                    [(2, 1, 2), (5, 10, 12), (7, 63, 64)]),
    "mixtral-window": (8, 32, 8, 128, 16, 512, 4160,
                       [1, 100, 4096, 4097, 4160, 5000, 8000, 8192], 4096,
                       False, [(1, 3, 4), (5, 260, 262), (7, 0, 5)]),
    "mixtral-ring": (8, 32, 8, 128, 16, 258, 2100,
                     [1, 100, 4096, 4097, 4160, 5000, 8000, 8192], 4096,
                     True, [(1, 3, 4), (5, 254, 256), (6, 257, 258)]),
}


def _int8_args(cuda, case, q_dtype, wpp):
    """q in ``q_dtype`` and K, V quantized as the KV cache stores them
    (int8 words, a float32 scale per (page, slot, kv head)), on the
    card."""
    from repro_torch.paged.kv_cache import _quant
    B, Hq, Hkv, D, page, P, NP, seq, window, ring, holes = INT8_CASES[case]
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
    args = [q.to(q_dtype).to(cuda), k8.to(cuda), v8.to(cuda),
            torch.from_numpy(table).to(cuda),
            torch.tensor(seq, dtype=torch.int32, device=cuda)]
    kw = dict(wpp=wpp, window=window, ring=ring, k_scale=ks.to(cuda),
              v_scale=vs.to(cuda))
    return args, kw


@pytest.mark.parametrize("case", tuple(INT8_CASES))
@pytest.mark.parametrize("q_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_int8_matches_plain(cuda, case, q_dtype, wpp):
    """int8 pages on the card: each element read as float(k8) * scale,
    q in float32 and bf16, both table modes, holes, windows and ring
    tables, qwen1.5-32b's G = 1 at 40 kv heads; atol 1e-5 of the plain
    version on the same values, one counted launch, and the scales
    change the result."""
    args, kw = _int8_args(cuda, case, q_dtype, wpp)
    ops.reset_launches()
    got = ops.paged_attention(*args, **kw)
    want = ref.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    assert float((got - want).abs().max()) <= 1e-5
    assert not bool(got[args[4] == 0].any())
    ones = torch.ones_like(kw["k_scale"])
    words = ref.paged_attention(*args, **{**kw, "k_scale": ones,
                                          "v_scale": ones})
    assert float((words - want).abs().max()) > 1e-3


def test_paged_attention_int8_refuses_what_it_cannot_take(cuda):
    """Pages in int8 without both scales, scales beside bf16 pages, K and
    V of two types, scales of another shape or type: each raises, and
    nothing launches (no call runs the plain version on the card)."""
    args, kw = _int8_args(cuda, "g4-d64", torch.bfloat16, None)
    q, k8, v8, table, seq = args
    ks, vs = kw["k_scale"], kw["v_scale"]
    bad = [
        ((q, k8, v8, table, seq), dict(k_scale=ks), TypeError),
        ((q, k8, v8, table, seq), dict(), TypeError),
        ((q, k8.to(torch.bfloat16), v8.to(torch.bfloat16), table, seq),
         dict(k_scale=ks, v_scale=vs), TypeError),
        ((q, k8, v8.to(torch.bfloat16), table, seq),
         dict(k_scale=ks, v_scale=vs), TypeError),
        ((q, k8, v8, table, seq),
         dict(k_scale=ks.double(), v_scale=vs), TypeError),
        ((q, k8, v8, table, seq),
         dict(k_scale=ks[:, :8].contiguous(), v_scale=vs), ValueError),
        ((q.half(), k8, v8, table, seq),
         dict(k_scale=ks, v_scale=vs), TypeError),
    ]
    ops.reset_launches()
    for a, extra, err in bad:
        with pytest.raises(err):
            ops.paged_attention(*a, **extra)
    assert ops.LAUNCHES["paged_attention"] == 0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,chunks,with_h0", [(1, 1, False), (1, 4, False),
                                              (1, 7, False), (2, 3, True),
                                              (2, 1, True)])
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
    assert DT._lib().defrag_txn_workspace_bytes(d, 1, AT.TABLE_SMEM_LIMIT) > 0
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


@pytest.mark.parametrize("n,C,cap,base,one", [
    (16, 3, 48, 0, None), (4096, 5, 10944, -2 ** 31 + 7, None),
    (4096, 5, 1000, 2 ** 31 - 300, None), (1, 5, 48, -2 ** 31 + 7, 4),
    (1, 1, 64, 2 ** 31 - 2, 0), (32, 32, 40, 2 ** 31 - 50, None),
    (33, 5, 48, -2 ** 31 + 3, None), (33, 32, 40, 0, None),
    (40, 33, 40, 2 ** 31 - 60, None), (1100, 3, 512, -2 ** 31 + 100, None),
    (6000, 5, 2000, 2 ** 31 - 1000, None),
    (10944, 5, 10944, 2 ** 31 - 5000, 0),
    (20000, 5, 5000, -2 ** 31 + 11, None)],
    ids=("16-lanes", "4096-lanes-wrapped", "4096-lanes-crossing",
         "1-lane-wrapped", "1-lane-pool-crossing", "32-lanes-32-classes",
         "33-lanes-wrapped", "33-lanes-32-classes",
         "40-lanes-33-classes-crossing", "1100-lanes-wrapped",
         "6000-lanes-crossing", "10944-lanes-one-class",
         "20000-lanes-wrapped"))
def test_ring_kernels_match_plain_on_the_card(cuda, n, C, cap, base, one):
    """``ring_txn_pop`` (both grants), ``ring_txn_push`` and
    ``ring_window`` against their plain versions on the same tensors of
    the card: multi-tile ranks, counters past 2^31, masked lanes and
    lanes of an out-of-range class (or every lane of class ``one``); one
    launch each, the pop and push on the path their launchers pick for
    n lanes of C classes (one warp, one block, a block per class), as
    the kernels counted it."""
    from repro_torch.kernels import alloc_txn as AT
    rng = np.random.default_rng(n + cap)
    store = torch.from_numpy(rng.integers(0, 10 ** 6, (C, cap))
                             .astype(np.int32)).to(cuda)
    front = base + rng.integers(0, 3 * cap, C)
    back = front + rng.integers(0 if one is None else 1, cap + 1, C)
    front, back = (torch.from_numpy(x.astype(np.int32)).to(cuda)
                   for x in (front, back))
    if one is None:
        cls = torch.from_numpy(rng.integers(-1, C + 1, n).astype(np.int32)
                               ).to(cuda)
        valid = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    else:
        cls = torch.full((n,), one, dtype=torch.int32, device=cuda)
        valid = torch.ones(n, dtype=torch.bool, device=cuda)
    vals = torch.from_numpy(rng.integers(0, 10 ** 6, n).astype(np.int32)
                            ).to(cuda)
    ops.reset_launches()
    AT.ring_launch_stats(reset=True)
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
    path = "class" if C > 32 else "warp" if n <= 32 else "block"
    ran = {k: v for k, v in AT.ring_launch_stats().items() if v}
    assert ran == {f"ring_txn_pop_{path}": 2, f"ring_txn_push_{path}": 1}, \
        ran


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


# --------------------------------------------------------------------------
# the fused decode mega-step on the card
# --------------------------------------------------------------------------

def _smoke_engine(cuda, arch, mega, kv_dtype=torch.bfloat16, **kw):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine
    cfg = get_arch(arch).smoke()
    m = build_model(cfg)
    return ServingEngine(m, m.init(0, device=cuda), kv_dtype=kv_dtype,
                         compute_dtype=torch.bfloat16, device=cuda,
                         mega_step=mega, **kw)


def _kv_dtype(arch):
    """qwen1.5-32b is the model int8 pages serve: its cases take them."""
    return torch.int8 if arch == "qwen1.5-32b" else torch.bfloat16


def _submit(eng, n=6, max_new=12, seed=0, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        eng.submit(rng.integers(2, eng.cfg.vocab_size,
                                int(rng.integers(lo, hi))),
                   max_new_tokens=max_new)


def _serve(eng, n=6, max_new=12, seed=0, lo=4, hi=60):
    _submit(eng, n, max_new, seed, lo, hi)
    return {r.uid: list(r.out_tokens) for r in eng.run_until_done(500)}


def _exhaust(eng):
    """The reference's exhaustion trace: a co-tenant binds every chunk
    to the 2048-B class and frees them."""
    dev = eng.device
    big = torch.full((16,), 2048, dtype=torch.int32, device=dev)
    eng.alloc_state, offs = eng.ouro.alloc(
        eng.alloc_state, big, torch.ones(16, dtype=torch.bool, device=dev))
    eng.alloc_state = eng.ouro.free(eng.alloc_state, offs, big, offs >= 0)


@pytest.mark.parametrize("arch,kw,pressure", [
    ("qwen2-0.5b", dict(max_batch=4, max_seq=96), False),
    ("qwen2-0.5b", dict(max_batch=4, max_seq=96, num_shards=4), False),
    ("qwen2-0.5b", dict(max_batch=2, max_seq=96, num_pages=16), True),
    ("mamba2-780m", dict(max_batch=4, max_seq=96), False),
    ("mixtral-8x7b", dict(max_batch=4, max_seq=96), False),
    ("qwen1.5-32b", dict(max_batch=4, max_seq=96, kv_dtype=torch.int8),
     False),
    ("qwen2-0.5b", dict(max_batch=2, max_seq=96, num_pages=16,
                        kv_dtype=torch.int8), True),
    ("recurrentgemma-9b", dict(max_batch=4, max_seq=96), False),
], ids=("qwen2", "qwen2-4-shards", "qwen2-exhausted", "mamba2", "mixtral",
        "qwen1.5-32b-int8", "qwen2-int8-exhausted", "hybrid"))
def test_mega_tokens_equal_host_loop_on_the_card(cuda, arch, kw, pressure):
    """bf16 compute on the card (bf16 KV, or int8 KV with scales): the
    mega-step gives the host loop's tokens, balances allocs and frees,
    leaves every table row a hole, and under exhaustion fails ticks and
    runs defrag waves."""
    out = []
    for mega in (False, True):
        eng = _smoke_engine(cuda, arch, mega, **kw)
        if pressure:
            _exhaust(eng)
        ops.reset_launches()
        toks = _serve(eng)
        torch.cuda.synchronize()
        out.append((toks, eng, dict(ops.LAUNCHES)))
    (host, _, _), (toks, eng, launches) = out
    assert toks == host and len(toks) == 6
    st = eng.stats
    assert st["allocs"] == st["frees"] and st["mega_step"] is True
    if eng.caches.kv is not None:
        assert bool((eng.caches.kv.page_table == -1).all())
        S = eng.num_shards
        grow = "alloc_txn" if S == 1 else "sharded_alloc_txn"
        assert launches[grow] == st["alloc_txns"] > 0
        L = num_attn_layers(eng.cfg)
        assert launches["paged_attention"] % L == 0
        # one grow a tick, beside the admissions' grants
        assert 0 < launches["paged_attention"] // L <= st["alloc_txns"]
    if pressure:
        assert st["alloc_failures"] > 0 and st["defrag_waves"] > 0
        assert launches["defrag_txn"] == st["defrag_waves"]
    eng._sync_shard_pages_from_table()
    assert not any(eng.stats["shard_pages_live"])
    assert not bool(eng.mega.active.any())


@pytest.mark.parametrize("mega", (True, False), ids=("mega", "host"))
@pytest.mark.parametrize("arch,S", [("qwen2-0.5b", 1), ("qwen2-0.5b", 4),
                                    ("mamba2-780m", 1), ("mixtral-8x7b", 1),
                                    ("qwen1.5-32b", 1),
                                    ("recurrentgemma-9b", 1)])
def test_launches_per_tick_on_the_card(cuda, arch, S, mega):
    """One grow transaction plus one ``paged_attention`` an attention
    layer for qwen2 (none for mamba2; one of recurrentgemma's four smoke
    layers) at max_batch 2 and 8, the allocator's part as its kernel
    counted it (``kernels.alloc_txn.launch_stats``)."""
    from repro_torch.kernels import alloc_txn as AT
    counts = []
    for mb in (2, 8):
        eng = _smoke_engine(cuda, arch, mega, max_batch=mb, max_seq=64,
                            num_shards=S, kv_dtype=_kv_dtype(arch))
        AT.launch_stats(reset=True)
        ops.reset_launches()
        n = eng.launches_per_tick()
        made = AT.launch_stats()
        counts.append(n)
        assert eng.stats["launches_per_tick"] == n == sum(
            ops.LAUNCHES.values())
        if eng.caches.kv is None:
            assert sum(made.values()) == 0
        else:
            grow = "alloc_txn" if S == 1 else "sharded_alloc_txn"
            assert ops.LAUNCHES[grow] == made[grow] == 1
            assert sum(made.values()) == 1
            assert ops.LAUNCHES["paged_attention"] == num_attn_layers(
                eng.cfg)
    want = 0 if eng.caches.kv is None else 1 + num_attn_layers(eng.cfg)
    assert counts == [want, want]


@pytest.mark.parametrize("arch,S", [("qwen2-0.5b", 1), ("qwen2-0.5b", 4),
                                    ("mamba2-780m", 1), ("mixtral-8x7b", 1),
                                    ("qwen1.5-32b", 1),
                                    ("recurrentgemma-9b", 1)])
def test_mega_tick_reads_the_card_once(cuda, arch, S):
    """Each steady tick (no admission, no retirement, no failure) makes
    exactly one synchronizing call, the flags' read: every step is run
    under ``set_sync_debug_mode("warn")`` and its warnings counted (the
    tick's device part itself runs under ``"error"``)."""
    import warnings
    eng = _smoke_engine(cuda, arch, True, max_batch=4, max_seq=96,
                        num_shards=S, kv_dtype=_kv_dtype(arch))
    rng = np.random.default_rng(1)
    for _ in range(4):
        eng.submit(rng.integers(2, eng.cfg.vocab_size, 20),
                   max_new_tokens=20)
    steady = []
    prev = torch.cuda.get_sync_debug_mode()
    try:
        while eng.waiting or any(r is not None for r in eng.slot_req):
            admitting = bool(eng.waiting)
            fails = eng.stats["alloc_failures"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                done = eng.step()
                torch.cuda.set_sync_debug_mode(prev)
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            if not (admitting or done
                    or eng.stats["alloc_failures"] != fails):
                steady.append(syncs)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert len(steady) >= 10
    assert set(steady) == {1}, steady


def test_mixtral_full_width_two_layers_both_loops(cuda):
    """mixtral-8x7b at its published widths, cut to 2 layers, bf16: a
    4160-token prompt (past the 4096-token window) beside short ones,
    through the host loop and the mega-step: the same tokens, each
    admission's aux grant of the quota (448 pages at 2 layers),
    ``allocs == frees``, no page held, ``launches_per_tick`` 3, and the
    kernel at the run's own inputs within atol 1e-5 of the plain
    version in a tick where the long request's window masks."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.paged.kv_cache import modality_page_quota
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), num_layers=2)
    m = build_model(cfg)
    params = m.init(0, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (4160, 20, 300)]
    quota = modality_page_quota(cfg)
    assert quota == 448
    out, worst, masked = [], [0.0], [0]
    kernel = ops.paged_attention

    def checked(q, k, v, table, seq, **kw):
        got = kernel(q, k, v, table, seq, **kw)
        if int(seq.max()) > cfg.sliding_window:
            masked[0] += 1
            want = ref.paged_attention(q, k, v, table, seq, **kw)
            worst[0] = max(worst[0], float((got - want).abs().max()))
        return got

    for mega in (False, True):
        eng = ServingEngine(m, params, max_batch=4, max_seq=4200,
                            kv_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, device=cuda,
                            mega_step=mega, max_new_cap=8)
        assert eng.launches_per_tick() == 1 + cfg.num_layers
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        grants, toks = [], {}
        while eng.waiting or any(r is not None for r in eng.slot_req):
            held = [len(a) for a in eng.slot_aux]
            for r in eng.step():
                toks[r.uid] = list(r.out_tokens)
            grants += [len(a) for a, h in zip(eng.slot_aux, held)
                       if len(a) and not h]
        assert grants == [quota] * len(prompts)
        st = eng.stats
        assert st["allocs"] == st["frees"] > 0
        assert bool((eng.caches.kv.page_table == -1).all())
        assert not any(a.size for a in eng.slot_aux)
        out.append(toks)
        if not mega:   # the kernel at the run's own inputs
            eng.alloc_state = eng.ouro.init()
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            ops.paged_attention = checked
            try:
                again = eng.run_until_done()
            finally:
                ops.paged_attention = kernel
            assert sorted(r.out_tokens for r in again) == sorted(
                toks.values())
        del eng
    assert out[0] == out[1] and len(out[0]) == 3
    assert masked[0] > 0 and worst[0] <= 1e-5


def test_qwen1_5_32b_full_width_two_layers_int8_both_loops(cuda):
    """qwen1.5-32b at the reference's widths (40 query and 40 kv heads of
    128, d_ff 27,392, vocab 152,064, untied), cut to 2 layers, bf16
    weights and int8 KV pages: prompts of 448, 20 and 300 tokens through
    the host loop and the mega-step give the same tokens,
    ``allocs == frees``, no page held, ``launches_per_tick`` 3, and the
    kernel at the run's own inputs (scales from the run's heaps) held to
    a float64 evaluation of the same words: within sqrt(D) times the
    plain version's own error, + 1e-5, a limit that the plain version
    staged in bf16 (the JAX reference's staging of int8 pages) must
    fail.  At two layers random weights drive |q| and |out| past 200,
    where two float32 summation orders of a score part by far more than
    1e-5 (the plain version alone is that far from float64), so atol
    1e-5 against the plain version cannot hold; the kernel sums a
    score's products in order, the plain version in blocks."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch("qwen1.5-32b"), num_layers=2)
    m = build_model(cfg)
    params = m.init(0, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (448, 20, 300)]
    out, calls = [], [0]
    err = {"kernel": 0.0, "plain": 0.0, "staged": 0.0}
    kernel = ops.paged_attention

    def checked(q, k, v, table, seq, **kw):
        got = kernel(q, k, v, table, seq, **kw)
        assert k.dtype == torch.int8 and kw["k_scale"] is not None
        want = ref.paged_attention(q, k, v, table, seq, **kw)
        exact = ref.paged_attention(q, k, v, table, seq,
                                    dtype=torch.float64, **kw)
        staged = ref.paged_attention(q, k, v, table, seq,
                                     stage=torch.bfloat16, **kw)
        for name, x in (("kernel", got), ("plain", want),
                        ("staged", staged)):
            err[name] = max(err[name], float((x - exact).abs().max()))
        calls[0] += 1
        return got

    for mega in (False, True):
        eng = ServingEngine(m, params, max_batch=4, max_seq=512,
                            kv_dtype=torch.int8,
                            compute_dtype=torch.bfloat16, device=cuda,
                            mega_step=mega, max_new_cap=8)
        assert eng.launches_per_tick() == 1 + cfg.num_layers
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        toks = {r.uid: list(r.out_tokens) for r in eng.run_until_done()}
        st = eng.stats
        assert st["allocs"] == st["frees"] > 0
        assert bool((eng.caches.kv.page_table == -1).all())
        assert bool(eng.caches.kv.layers.k_scale.any())
        out.append(toks)
        if not mega:   # the kernel at the run's own inputs
            eng.alloc_state = eng.ouro.init()
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            ops.paged_attention = checked
            try:
                again = eng.run_until_done()
            finally:
                ops.paged_attention = kernel
            assert sorted(r.out_tokens for r in again) == sorted(
                toks.values())
        del eng
    assert out[0] == out[1] and len(out[0]) == 3
    assert calls[0] >= 7 * cfg.num_layers
    limit = cfg.head_dim_ ** 0.5 * err["plain"] + 1e-5
    print(f"errors against float64 {err}: kernel / plain "
          f"{err['kernel'] / err['plain']:.3g}, staged / plain "
          f"{err['staged'] / err['plain']:.3g}, limit {limit:.3g}")
    assert err["kernel"] <= limit < err["staged"], err


def test_hybrid_full_width_four_layers_both_loops(cuda):
    """recurrentgemma-9b at its full widths (d_model 4096, lru_width 4096,
    16 query heads on 1 kv head of 256, d_ff 12,288 GeGLU, vocab
    256,000, untied), cut to 4 layers (one (RG-LRU, RG-LRU, local
    attention) triple and one RG-LRU layer), bf16: a 4160-token prompt
    (past the 2,048-token window) beside short ones through the host
    loop and the mega-step give the same tokens, each admission's aux
    grant of the quota (480 pages at 3 recurrent layers),
    ``allocs == frees``, no page held, ``launches_per_tick`` 2; and the
    kernel at the run's own inputs of the ticks where the long
    request's window masks held to the plain version at atol 1e-5."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.paged.kv_cache import modality_page_quota
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"), num_layers=4)
    m = build_model(cfg)
    params = m.init(0, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (4160, 20, 300)]
    quota = modality_page_quota(cfg)
    assert quota == 480
    out, masked, err = [], [0], [0.0]
    kernel = ops.paged_attention

    def checked(q, k, v, table, seq, **kw):
        got = kernel(q, k, v, table, seq, **kw)
        assert kw["window"] == cfg.local_window and kw["ring"]
        if int(seq.max()) > cfg.local_window:
            masked[0] += 1
            want = ref.paged_attention(q, k, v, table, seq, **kw)
            err[0] = max(err[0], float((got - want).abs().max()))
        return got

    for mega in (False, True):
        eng = ServingEngine(m, params, max_batch=4, max_seq=4200,
                            kv_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, device=cuda,
                            mega_step=mega, max_new_cap=8)
        assert eng.launches_per_tick() == 1 + num_attn_layers(cfg) == 2
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        grants, toks = [], {}
        while eng.waiting or any(r is not None for r in eng.slot_req):
            held = [len(a) for a in eng.slot_aux]
            for r in eng.step():
                toks[r.uid] = list(r.out_tokens)
            grants += [len(a) for a, h in zip(eng.slot_aux, held)
                       if len(a) and not h]
        assert grants == [quota] * len(prompts)
        st = eng.stats
        assert st["allocs"] == st["frees"] > 0
        assert bool((eng.caches.kv.page_table == -1).all())
        assert not any(a.size for a in eng.slot_aux)
        assert bool(torch.isfinite(eng.caches.ssm_h).all())
        out.append(toks)
        if not mega:   # the kernel at the run's own inputs
            eng.alloc_state = eng.ouro.init()
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            ops.paged_attention = checked
            try:
                again = eng.run_until_done()
            finally:
                ops.paged_attention = kernel
            assert sorted(r.out_tokens for r in again) == sorted(
                toks.values())
        del eng
    assert out[0] == out[1] and len(out[0]) == 3
    assert masked[0] > 0
    print(f"recurrentgemma 4 layers: {masked[0]} masking calls, max error "
          f"{err[0]:.3g}")
    assert err[0] <= 1e-5, err



# the decode shapes of the encoder-decoder (seamless-m4t-large-v2: 16
# query heads over 16 kv heads of 64, G 1) and the VLM (qwen2-vl-2b: 12
# over 2 of 128, G 6)
NEW_SHAPES = {"seamless-G1-D64": (16, 16, 64), "qwen2-vl-G6-D128": (12, 2, 128)}


@pytest.mark.parametrize("shape", tuple(NEW_SHAPES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_at_the_encdec_and_vlm_shapes(cuda, shape, dtype,
                                                      wpp):
    """B 8 on a 32-slot table (max_seq 512), ragged lengths 0-512, a hole
    inside a live split and a split of holes: atol 1e-5 of the plain
    version, one counted launch, a zero-length row all 0."""
    Hq, Hkv, D = NEW_SHAPES[shape]
    rng = np.random.default_rng(Hq + D)
    B, page, P, NP = 8, 16, 32, 300
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[4, 2] = -1
    table[6, 4:8] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    seq = np.array([0, 1, 17, 512, 100, 255, 300, 511], np.int32)
    args = [x.to(dtype).to(cuda) for x in (q, k, v)] + [
        torch.from_numpy(table).to(cuda), torch.from_numpy(seq).to(cuda)]
    ops.reset_launches()
    got = ops.paged_attention(*args, wpp=wpp)
    want = ref.paged_attention(*args, wpp=wpp)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    assert float((got - want).abs().max()) <= 1e-5
    assert not bool(got[0].any())


def _both_loops_full_width(cuda, cfg, lens, max_seq=512):
    """``cfg`` at full width in bf16 through the host loop and the
    mega-step: the same tokens, ``allocs == frees``, no page held,
    ``launches_per_tick`` 1 + the decoder's layers; every
    ``paged_attention`` call of a rerun of the host loop's traffic held
    to the plain version at atol 1e-5.  Returns (tokens, max error,
    calls checked)."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine
    m = build_model(cfg)
    params = m.init(0, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in lens]
    out, calls = [], [0]
    err = {"plain": 0.0, "kernel64": 0.0, "plain64": 0.0, "staged64": 0.0,
           "out": 0.0}
    kernel = ops.paged_attention

    def checked(q, k, v, table, seq, **kw):
        got = kernel(q, k, v, table, seq, **kw)
        want = ref.paged_attention(q, k, v, table, seq, **kw)
        exact = ref.paged_attention(q, k, v, table, seq,
                                    dtype=torch.float64, **kw)
        staged = ref.paged_attention(q, k, v, table, seq,
                                     stage=torch.bfloat16, **kw)
        for name, x, y in (("plain", got, want), ("kernel64", got, exact),
                           ("plain64", want, exact),
                           ("staged64", staged, exact),
                           ("out", want, torch.zeros_like(want))):
            err[name] = max(err[name], float((x - y).abs().max()))
        calls[0] += 1
        return got

    for mega in (False, True):
        eng = ServingEngine(m, params, max_batch=4, max_seq=max_seq,
                            kv_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, device=cuda,
                            mega_step=mega, max_new_cap=8)
        assert eng.launches_per_tick() == 1 + num_attn_layers(cfg)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        toks = {r.uid: list(r.out_tokens) for r in eng.run_until_done()}
        st = eng.stats
        assert st["allocs"] == st["frees"] > 0
        assert bool((eng._kv().page_table == -1).all())
        out.append(toks)
        if not mega:
            eng.alloc_state = eng.ouro.init()
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            ops.paged_attention = checked
            try:
                again = eng.run_until_done()
            finally:
                ops.paged_attention = kernel
            assert sorted(r.out_tokens for r in again) == sorted(
                toks.values())
        del eng
    assert out[0] == out[1] and len(out[0]) == len(lens)
    print(f"{cfg.name} {cfg.num_layers} layers: {calls[0]} checked calls, "
          f"errors {err}")
    return out[0], err, calls[0]


def test_encdec_full_width_four_layers_both_loops(cuda):
    """seamless-m4t-large-v2 at its full widths (d_model 1024, 16 heads
    of 64 over 16 kv heads, d_ff 8,192 GeGLU, LayerNorm, vocab 256,256
    untied), cut to 4 encoder and 4 decoder layers: prompts of 300, 20
    and 5 tokens over 512 encoder frames each, the same tokens in both
    loops, ``launches_per_tick`` 5, and the kernel (G 1, D 64) at the
    run's own inputs held to a float64 evaluation of the same words:
    within sqrt(D) times the plain version's own error, + 1e-5, a limit
    that the plain version staged in bf16 must fail.  At four layers
    random weights drive |out| to 70 and the scores into the hundreds,
    where two float32 summation orders part by ~6e-4 (each as far from
    float64), so atol 1e-5 against the plain version cannot hold."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("seamless-m4t-large-v2"),
                              num_layers=4, enc_layers=4)
    toks, err, calls = _both_loops_full_width(cuda, cfg, (300, 20, 5))
    assert calls >= 7 * cfg.num_layers
    limit = cfg.head_dim_ ** 0.5 * err["plain64"] + 1e-5
    assert err["kernel64"] <= limit < err["staged64"], err


def test_vlm_full_width_four_layers_both_loops(cuda):
    """qwen2-vl-2b at its full widths (d_model 1536, 12 heads of 128 over
    2 kv heads, M-RoPE sections (16, 24, 24), QKV bias, tied
    embeddings), cut to 4 layers: the same tokens in both loops,
    ``launches_per_tick`` 5, the kernel (G 6, D 128) at the run's own
    inputs within atol 1e-5; and a float32 prefill with ``mm_embeds``
    and three distinct position streams on the card within 1e-3 of the
    same prefill on the CPU (TF32 off)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_arch("qwen2-vl-2b"), num_layers=4)
    toks, err, calls = _both_loops_full_width(cuda, cfg, (300, 20, 5))
    assert calls >= 7 * cfg.num_layers
    assert err["plain"] <= 1e-5, err
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    rng = np.random.default_rng(1)
    S = 40
    toks_ = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)))
    mm = torch.from_numpy(0.1 * rng.standard_normal((1, S, cfg.d_model))
                          .astype(np.float32))
    pos = torch.from_numpy(np.stack([np.arange(S), np.arange(S) // 8,
                                     np.arange(S) % 8])[None])
    logits = []
    for dev in ("cpu", cuda):
        c = m.make_decode_caches(1, 64, kv_dtype=torch.float32, device=dev)
        c.kv.page_table.copy_(torch.arange(4, dtype=torch.int32)[None])
        lg, _ = m.prefill(_to(params, dev), {
            "tokens": toks_.to(dev), "mm_embeds": mm.to(dev),
            "positions": pos.to(dev)}, c, dtype=torch.float32)
        logits.append(lg.cpu())
    print(f"qwen2-vl prefill, card against CPU: "
          f"{float((logits[0] - logits[1]).abs().max()):.3g}")
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-3


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


LAST_SHAPES = {"command-r-G8-D128": (64, 8, 128),
               "internlm2-G6-D128": (48, 8, 128)}


@pytest.mark.parametrize("shape", tuple(LAST_SHAPES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_at_the_command_r_and_internlm2_shapes(cuda, shape,
                                                               dtype, wpp):
    """command-r-35b's decode shape (Hq 64 over Hkv 8: G 8, D 128) and
    internlm2-20b's (Hq 48 over Hkv 8: G 6, D 128), B 8 on a 64-slot
    table (max_seq 1,024), ragged lengths 0-1,024, a hole inside a live
    split and a split of holes: atol 1e-5 of the plain version, one
    counted launch, a zero-length row all 0."""
    Hq, Hkv, D = LAST_SHAPES[shape]
    rng = np.random.default_rng(Hq + D)
    B, page, P, NP = 8, 16, 64, 600
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[4, 2] = -1
    table[6, 4:8] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    seq = np.array([0, 1, 17, 1024, 100, 255, 300, 1023], np.int32)
    args = [x.to(dtype).to(cuda) for x in (q, k, v)] + [
        torch.from_numpy(table).to(cuda), torch.from_numpy(seq).to(cuda)]
    ops.reset_launches()
    got = ops.paged_attention(*args, wpp=wpp)
    want = ref.paged_attention(*args, wpp=wpp)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    assert float((got - want).abs().max()) <= 1e-5
    assert not bool(got[0].any())


@pytest.mark.parametrize("arch", ("command-r-35b", "internlm2-20b"))
def test_last_dense_full_width_four_layers_both_loops(cuda, arch):
    """command-r-35b (d_model 8192, 64 heads over 8 kv heads of 128,
    d_ff 22,528, LayerNorm, the parallel block, vocab 256,000 tied) and
    internlm2-20b (d_model 6144, 48 heads over 8, d_ff 16,384, vocab
    92,544 untied) at full width, cut to 4 layers, bf16: the same
    tokens in both loops, ``allocs == frees``, ``launches_per_tick`` 5,
    and every ``paged_attention`` call of a rerun of the host loop's
    traffic within atol 1e-5 of the plain version (7.6e-6 on the card
    for both, |out| up to 214)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), num_layers=4)
    toks, err, calls = _both_loops_full_width(cuda, cfg, (300, 20, 5))
    assert calls >= 7 * cfg.num_layers
    assert all(0 <= t < cfg.padded_vocab for ts in toks.values() for t in ts)
    assert err["plain"] <= 1e-5, err


def test_phi3_5_moe_full_width_four_layers_both_loops(cuda):
    """phi3.5-moe at its full widths (d_model 4096, 32 heads over 8 kv
    heads of 128, 16 experts of d_ff 6,400, top-2, vocab 32,064
    untied), cut to 4 of its 32 layers (its 83.7 GB of bf16 weights do
    not fit one card), bf16: the same tokens in both loops, each
    admission's aux grant of the quota, ``allocs == frees``, no page
    held, ``launches_per_tick`` 5, and every ``paged_attention`` call of
    a rerun of the host loop's traffic within atol 1e-5 of the plain
    version."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.paged.kv_cache import modality_page_quota
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"), num_layers=4)
    quota = modality_page_quota(cfg)
    assert quota == 400          # 4 layers x top-2 x 6,400 x 2 B / 256 B
    grants, grant = [], ServingEngine._alloc_aux

    def recorded(self, slot):
        ok = grant(self, slot)
        if ok:
            grants.append(len(self.slot_aux[slot]))
        return ok
    ServingEngine._alloc_aux = recorded
    try:
        toks, err, calls = _both_loops_full_width(cuda, cfg, (300, 20, 5))
    finally:
        ServingEngine._alloc_aux = grant
    assert grants and set(grants) == {quota}
    assert calls >= 7 * cfg.num_layers
    assert err["plain"] <= 1e-5, err


@pytest.mark.parametrize("arch,scenario", [("qwen2-0.5b", "bursty"),
                                           ("qwen2-0.5b", "abandon"),
                                           ("mamba2-780m", "abandon")])
def test_replay_pair_on_the_card(cuda, arch, scenario):
    """The port's replay harness on the card (float32 smoke engines):
    the host loop and the mega-step give the same tokens per uid and
    cancels, both conserve every page; only ticks that load a kernel
    library count as compiled (none of the mega-step's, which runs the
    host loop's kernels after it)."""
    from repro_torch.kernels import build
    from repro_torch.serve import replay as rp
    cfg, make = rp.engine_factory(arch, device=cuda)
    trace = rp.generate_trace(rp.SCENARIOS[scenario], seed=0,
                              vocab_size=cfg.vocab_size)
    host, mega = rp.replay_pair(make(mega=False), make(mega=True), trace,
                                scenario=scenario)
    assert host.tokens == mega.tokens and host.tokens
    assert host.cancelled == mega.cancelled
    assert (scenario == "abandon") == bool(host.cancelled)
    assert sum(host.compiled) <= len(build.SOURCES)
    assert not any(mega.compiled)
    for r in (host, mega):
        s = r.summary()
        assert s["allocs"] == s["frees"] > 0
        assert s["completed"] + s["cancelled"] == len(trace)


def _snapshot_words(eng):
    """Every snapshot leaf of ``eng`` as host words (bf16 as int16)."""
    from repro_torch.ckpt import checkpoint as CK
    return {k: CK.to_host(v)[0]
            for k, v in CK.flatten(eng._snapshot_tree()).items()}


def _same_words(a, b):
    wa, wb = _snapshot_words(a), _snapshot_words(b)
    assert wa.keys() == wb.keys()
    for k in wa:
        np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


@pytest.mark.parametrize("S", (1, 4))
@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_snapshot_restore_on_the_card(cuda, tmp_path, mega, S):
    """Snapshot mid-decode on the card, in memory and to disk; fresh
    engines restore both in place (the arena's storage stays the
    engine's own): every word equals the source's, and both finish with
    an uninterrupted run's tokens, allocs == frees, every kernel of the
    path launched after the restore."""
    kw = dict(max_batch=4, max_seq=96, num_shards=S)
    want = _serve(_smoke_engine(cuda, "qwen2-0.5b", mega, **kw))
    src = _smoke_engine(cuda, "qwen2-0.5b", mega, **kw)
    _submit(src)
    early = []
    for _ in range(4):
        early += src.step()
    snap = src.snapshot()
    assert src.snapshot(directory=str(tmp_path)).endswith("step_00000004")
    for source in (snap, str(tmp_path)):
        dst = _smoke_engine(cuda, "qwen2-0.5b", mega, **kw)
        mem = dst.alloc_state.mem
        dst.restore(source)
        assert dst.alloc_state.mem is mem and mem.is_cuda
        _same_words(src, dst)
        ops.reset_launches()
        rest = dst.run_until_done(500)
        torch.cuda.synchronize()
        assert {r.uid: list(r.out_tokens) for r in early + rest} == want
        assert dst.stats["allocs"] == dst.stats["frees"]
        pre = "" if S == 1 else "sharded_"
        assert all(ops.LAUNCHES[k] for k in (pre + "alloc_txn",
                                             pre + "free_txn",
                                             "paged_attention"))


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_snapshot_moves_between_cpu_and_card(cuda, tmp_path, mega):
    """float32 smoke engines over the same weights: a snapshot the CPU
    engine took restores on the card with the same words, and one the
    card engine took (after serving on) restores on the CPU with the
    same words, from memory and from disk."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine
    cfg = get_arch("qwen2-0.5b").smoke()
    m = build_model(cfg)
    params = m.init(0, device="cpu")

    def on(x, dev):
        if isinstance(x, dict):
            return {k: on(v, dev) for k, v in x.items()}
        if isinstance(x, list):
            return [on(v, dev) for v in x]
        return x.to(dev)

    def make(dev):
        return ServingEngine(m, on(params, dev), max_batch=4, max_seq=96,
                             kv_dtype=torch.float32,
                             compute_dtype=torch.float32, device=dev,
                             mega_step=mega)
    cpu = make("cpu")
    _submit(cpu)
    for _ in range(3):
        cpu.step()
    card = make(cuda)
    card.restore(cpu.snapshot())
    _same_words(cpu, card)
    for _ in range(3):
        card.step()
    card.snapshot(directory=str(tmp_path))
    back = make("cpu")
    back.restore(str(tmp_path))
    _same_words(card, back)
    assert [r and r.uid for r in back.slot_req] == \
        [r and r.uid for r in card.slot_req]
