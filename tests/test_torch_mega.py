"""The port's fused decode mega-step held to the JAX reference.

The same numpy-seeded inputs go through the reference
(``repro``, jnp backend: its mega-step's oracle) and the port
(``device="cpu"``, where every kernel runs its plain version):

- ``grow_lanes``, ``Ouroboros.grow`` (single arena and sharded) and
  ``kv_cache.scatter_grant_words``: lane outputs and arena words word for
  word; ``_store`` (``append1``, ``prefill_write1``) with holes and ids
  past the heap;
- the engine with ``mega_step=True`` against the reference's
  ``mega_step=True``: tokens per uid, shared stats and final arena words,
  in the cases of the reference's ``tests/test_serve_mega.py`` (S = 1 and
  4, one new token, EOS, ``max_new_cap``, exhaustion recovery, eviction,
  cancel, mamba2), and the port's host loop giving the same tokens.

Everything runs float32, as the reference's mega-step tests do: greedy
tokens must match exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.core import HeapConfig as JHeap, Ouroboros as JOuro
from repro.core import transactions as jT
from repro.models.model import build_model as jbuild
from repro.paged import kv_cache as JKV
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.core import HeapConfig, Ouroboros
from repro_torch.core import transactions as T
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines here run many small ops: one intra-op thread a test
    process keeps them from thrashing when several test processes share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_words(js, ts, what):
    for name in ("mem", "ctl"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        diff = np.argwhere(a != b)
        assert diff.size == 0, f"{what}: {name} differs at {diff[:4]}"


# --------------------------------------------------------------------------
# grow_lanes, Ouroboros.grow, scatter_grant_words
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,lanes,hi,seed", [
    (3, 4, 3, 0), (8, 8, 2, 1), (8, 16, 4, 2),
    (5, 4, 3, 3),          # demand past the lanes: truncated
    (4, 6, 1, 4)])         # mostly zeros
def test_grow_lanes_matches_reference(B, lanes, hi, seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        need = rng.integers(0, hi + 1, B).astype(np.int32)
        want = jT.grow_lanes(jnp.asarray(need), lanes)
        got = T.grow_lanes(torch.from_numpy(need), lanes)
        for a, b, nm in zip(want, got, ("slot", "rank", "mask")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=nm)
        assert got[0].dtype == got[1].dtype == torch.int32


GROW_CFG = dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=64)


@pytest.mark.parametrize("variant", ("vl_chunk", "page"))
@pytest.mark.parametrize("S", (1, 2, 4))
def test_grow_matches_reference(variant, S):
    """Seeded grows (with homes when sharded) and frees of some grants
    in lockstep until the heap runs short: the lane outputs and the
    arena words equal the reference's after every transaction."""
    kw = {} if S == 1 else {"num_shards": S}
    oj = JOuro(JHeap(**GROW_CFG), variant, **kw)
    ot = Ouroboros(HeapConfig(**GROW_CFG), variant, device="cpu", **kw)
    sj, st = oj.init(), ot.init()
    rng = np.random.default_rng(S)
    B, lanes, size = 6, 8, 2048
    grow_j = jax.jit(lambda s_, n_, h_: oj.grow(s_, n_, size, lanes, home=h_))
    live, failed = [], 0
    for step in range(10):
        need = rng.integers(0, 3, B).astype(np.int32)
        home = (rng.integers(0, 2 * S, B).astype(np.int32)
                if S > 1 and step % 2 else None)
        hj = None if home is None else jnp.asarray(home)
        ht = None if home is None else torch.from_numpy(home)
        sj, *outj = grow_j(sj, jnp.asarray(need), hj)
        st, *outt = ot.grow(st, torch.from_numpy(need), size, lanes,
                            home=ht)
        for a, b, nm in zip(outj, outt, ("offs", "slot", "rank", "mask")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"step {step}: {nm}")
        _same_words(sj, st, f"grow {step}")
        offs = outt[0].numpy()
        failed += int(((offs < 0) & outt[3].numpy()).sum())
        live += [int(o) for o in offs if o >= 0]
        if step % 3 == 2 and live:
            k = len(live) // 2
            fo = np.full(lanes * 2, -1, np.int32)
            fo[:k] = live[:k]
            live = live[k:]
            sizes = np.full(fo.shape[0], size, np.int32)
            sj = oj.free(sj, jnp.asarray(fo), jnp.asarray(sizes),
                         jnp.asarray(fo >= 0))
            st = ot.free(st, torch.from_numpy(fo), torch.from_numpy(sizes),
                         torch.from_numpy(fo >= 0))
            _same_words(sj, st, f"free {step}")
    assert live and failed > 0, "the trace never ran the heap short"


def test_grow_home_needs_shards():
    ot = Ouroboros(HeapConfig(**GROW_CFG), "vl_chunk", device="cpu")
    with pytest.raises(ValueError, match="home"):
        ot.grow(ot.init(), torch.ones(2, dtype=torch.int32), 256, 4,
                home=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("seed", range(4))
def test_scatter_grant_words_matches_reference(seed):
    """Random tables, counts and lanes (some not granted, some past the
    table's last column): the same table as the reference's drop-mode
    scatter, updated in place."""
    rng = np.random.default_rng(seed)
    B, Pn, lanes, wpp = 5, 6, 8, 64
    table = rng.integers(-1, 40, (B, Pn)).astype(np.int32)
    counts = rng.integers(0, Pn + 1, B).astype(np.int32)
    need = rng.integers(0, 3, B).astype(np.int32)
    slot, rank, mask = (np.asarray(x) for x in
                        jT.grow_lanes(jnp.asarray(need), lanes))
    offs = np.where(mask, rng.integers(0, 60, lanes) * wpp,
                    -1).astype(np.int32)
    ok = mask & (rng.random(lanes) < 0.8)
    want = JKV.scatter_grant_words(
        jnp.asarray(table), jnp.asarray(counts), jnp.asarray(slot),
        jnp.asarray(rank), jnp.asarray(offs), jnp.asarray(ok), wpp)
    pt = torch.from_numpy(table.copy())
    got = KV.scatter_grant_words(
        pt, torch.from_numpy(counts), torch.from_numpy(slot),
        torch.from_numpy(rank), torch.from_numpy(offs),
        torch.from_numpy(ok), wpp)
    assert got is pt
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# _store: fixed-shape writes, holes and ids past the heap drop
# --------------------------------------------------------------------------

def _heaps(rng, NP=6, page=4, H=2, D=3):
    k = rng.standard_normal((NP, page, H, D)).astype(np.float32)
    v = rng.standard_normal((NP, page, H, D)).astype(np.float32)
    return (JKV.KVLayer(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=None,
                        v_scale=None),
            KV.KVLayer(k=torch.from_numpy(k.copy()),
                       v=torch.from_numpy(v.copy())))


@pytest.mark.parametrize("table", [
    [[0, 3, -1], [5, -1, 2], [-1, -1, -1]],     # holes, one empty row
    [[6, 9, 1], [4, 0, -7], [2, 3, 5]],          # ids past the heap
    [[-1, -1, -1], [-1, -1, -1], [-1, -1, -1]],  # nothing mapped
], ids=("holes", "past-heap", "all-holes"))
def test_store_matches_reference(table):
    """``append1`` at ragged lengths (some past the table) and
    ``prefill_write1`` at two offsets: the same heap words as the
    reference, in place."""
    rng = np.random.default_rng(0)
    table = np.asarray(table, np.int32)
    B, H, D, page = 3, 2, 3, 4
    jl, tl = _heaps(rng)
    k_id = tl.k.data_ptr()
    seq = np.asarray([1, 6, 13], np.int32)
    kt = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    vt = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    jl = JKV.append1(jl, jnp.asarray(table), jnp.asarray(seq),
                     jnp.asarray(kt), jnp.asarray(vt))
    tl = KV.append1(tl, torch.from_numpy(table), torch.from_numpy(seq),
                    torch.from_numpy(kt), torch.from_numpy(vt))
    for pos0, S in ((0, 9), (5, 4)):
        kp = rng.standard_normal((B, S, H, D)).astype(np.float32)
        vp = rng.standard_normal((B, S, H, D)).astype(np.float32)
        jl = JKV.prefill_write1(jl, jnp.asarray(table), jnp.asarray(kp),
                                jnp.asarray(vp), pos0=pos0)
        tl = KV.prefill_write1(tl, torch.from_numpy(table),
                               torch.from_numpy(kp), torch.from_numpy(vp),
                               pos0=pos0)
    assert tl.k.data_ptr() == k_id
    np.testing.assert_array_equal(tl.k.numpy(), np.asarray(jl.k))
    np.testing.assert_array_equal(tl.v.numpy(), np.asarray(jl.v))


# --------------------------------------------------------------------------
# the engine's mega-step, port against reference
# --------------------------------------------------------------------------

STATS = ("allocs", "frees", "alloc_failures", "alloc_txns", "defrag_waves",
         "pages_migrated", "evictions", "cancels", "mega_step",
         "shard_pages_live")


def _models(arch):
    cfg = jget(arch).smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_arch(arch).smoke()
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def qwen():
    return _models("qwen2-0.5b")


@pytest.fixture(scope="module")
def mamba():
    return _models("mamba2-780m")


def _engines(models, mega=True, **kw):
    """(reference mega engine, port engine) with the same geometry."""
    jm, jp, tm, tp = models
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=True, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


def _port(models, mega, **kw):
    _, _, tm, tp = models
    return ServingEngine(tm, tp, kv_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu",
                         mega_step=mega, **kw)


def _submit(engines, prompts, max_new, eos=None):
    for p in prompts:
        uids = {e.submit(p, max_new_tokens=max_new, eos_id=eos)
                for e in engines}
        assert len(uids) == 1


def _prompts(cfg_vocab, n, seed, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg_vocab, int(rng.integers(lo, hi)))
            for _ in range(n)]


def _tokens(done):
    return {r.uid: list(map(int, r.out_tokens)) for r in done}


def _same_engines(je, te, done_j, done_t):
    """Tokens per uid, shared stats and final arena words; returns the
    port's tokens."""
    got, want = _tokens(done_t), _tokens(done_j)
    assert got == want
    shared = set(je.stats) & set(te.stats)
    assert set(STATS) <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    _same_words(je.alloc_state, te.alloc_state, "engine arena")
    if te.caches.kv is not None:
        np.testing.assert_array_equal(te.caches.kv.page_table.numpy(),
                                      np.asarray(je.caches.kv.page_table))
    assert te.stats["allocs"] == te.stats["frees"]
    return got


@pytest.fixture(scope="module")
def basic(qwen):
    """The reference's basic mega trace (4 requests, 5 new tokens,
    max_batch 3) through the port's host loop: the tokens every mode
    must give."""
    vocab = get_arch("qwen2-0.5b").smoke().vocab_size
    prompts = _prompts(vocab, 4, 0)
    host = _port(qwen, False, max_batch=3, max_seq=96)
    _submit([host], prompts, 5)
    toks = _tokens(host.run_until_done(300))
    assert len(toks) == 4 and host.stats["allocs"] == host.stats["frees"]
    return prompts, toks


@pytest.mark.parametrize("S", (1, 4))
def test_mega_matches_reference_mega_and_host_loop(qwen, basic, S):
    prompts, host_toks = basic
    je, te = _engines(qwen, max_batch=3, max_seq=96, num_shards=S)
    _submit((je, te), prompts, 5)
    got = _same_engines(je, te, je.run_until_done(300),
                        te.run_until_done(300))
    assert got == host_toks
    assert te.stats["alloc_failures"] == 0
    assert te.stats["mega_step"] is True
    assert bool((te.caches.kv.page_table == -1).all())
    assert not bool(te.mega.active.any())


def test_mega_max_new_one_gives_two_tokens(qwen):
    """``max_new_tokens=1`` yields two tokens (the prefill's and one
    decode's) in both packages and both modes."""
    vocab = get_arch("qwen2-0.5b").smoke().vocab_size
    prompts = _prompts(vocab, 2, 0)
    je, te = _engines(qwen, max_batch=3, max_seq=96)
    host = _port(qwen, False, max_batch=3, max_seq=96)
    _submit((je, te, host), prompts, 1)
    got = _same_engines(je, te, je.run_until_done(300),
                        te.run_until_done(300))
    assert got == _tokens(host.run_until_done(300))
    assert all(len(t) == 2 for t in got.values())


def test_mega_eos_cut(qwen):
    """An EOS taken from the host loop's own stream cuts request 1 short
    on the same tick in every mode."""
    vocab = get_arch("qwen2-0.5b").smoke().vocab_size
    prompts = _prompts(vocab, 2, 3)
    probe = _port(qwen, False, max_batch=3, max_seq=96)
    _submit([probe], prompts, 6)
    eos = _tokens(probe.run_until_done(300))[1][2]
    je, te = _engines(qwen, max_batch=3, max_seq=96)
    host = _port(qwen, False, max_batch=3, max_seq=96)
    _submit((je, te, host), prompts, 6, eos=eos)
    got = _same_engines(je, te, je.run_until_done(300),
                        te.run_until_done(300))
    assert got == _tokens(host.run_until_done(300))
    assert len(got[1]) < 6 and got[1][-1] == eos


def test_mega_rejects_overlong_request_and_bad_cap(qwen):
    jm, jp, tm, tp = qwen
    te = _port(qwen, True, max_batch=2, max_seq=64, max_new_cap=8)
    je = JEngine(jm, jp, max_batch=2, max_seq=64, kv_dtype=jnp.float32,
                 mega_step=True, max_new_cap=8)
    for e in (je, te):
        with pytest.raises(ValueError, match="max_new_cap"):
            e.submit(np.arange(2, 10), max_new_tokens=9)
        e.submit(np.arange(2, 10), max_new_tokens=8)
    for cap in (0, -1, 2.5):
        with pytest.raises(ValueError, match="max_new_cap"):
            _port(qwen, True, max_batch=2, max_seq=64, max_new_cap=cap)


def test_mega_recovers_from_exhaustion(qwen):
    """The reference's exhaustion trace: a co-tenant binds every chunk
    to the 2048-B class and frees them; the mega tick's grants fail, the
    flags report it, the host returns the partial grants and runs defrag
    waves, and the retried ticks give the host loop's tokens."""
    vocab = get_arch("qwen2-0.5b").smoke().vocab_size
    prompts = _prompts(vocab, 2, 1, 40, 41)
    kw = dict(max_batch=2, max_seq=64, num_pages=16)
    je, te = _engines(qwen, **kw)
    host = _port(qwen, False, **kw)
    n = 16
    big = np.full(n, 2048, np.int32)
    je.alloc_state, oj = je.ouro.alloc(je.alloc_state, jnp.asarray(big),
                                       jnp.ones(n, bool))
    je.alloc_state = je.ouro.free(je.alloc_state, oj, jnp.asarray(big),
                                  oj >= 0)
    for e in (te, host):
        e.alloc_state, ot = e.ouro.alloc(e.alloc_state,
                                         torch.from_numpy(big),
                                         torch.ones(n, dtype=torch.bool))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        e.alloc_state = e.ouro.free(e.alloc_state, ot,
                                    torch.from_numpy(big), ot >= 0)
    _submit((je, te, host), prompts, 8)
    got = _same_engines(je, te, je.run_until_done(100),
                        te.run_until_done(100))
    assert got == _tokens(host.run_until_done(100))
    assert te.stats["alloc_failures"] > 0 and te.stats["defrag_waves"] > 0


def test_mega_evicts_under_a_cotenant_then_replays(qwen):
    """The reference's co-tenant trace: the heap is held live but two
    pages, so defrag cannot help; the mega tick fails twice, the
    youngest slot is evicted and requeued (no exception), and once the
    co-tenant lets go the request replays with the host loop's tokens."""
    vocab = get_arch("qwen2-0.5b").smoke().vocab_size
    prompt = np.random.default_rng(1).integers(2, vocab, 30)
    kw = dict(max_batch=2, max_seq=64, num_pages=16)
    je, te = _engines(qwen, **kw)
    sizes = np.full(64, 256, np.int32)
    je.alloc_state, oj = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                       jnp.ones(64, bool))
    te.alloc_state, ot = te.ouro.alloc(te.alloc_state,
                                       torch.from_numpy(sizes),
                                       torch.ones(64, dtype=torch.bool))
    offs = ot.numpy()
    np.testing.assert_array_equal(offs, np.asarray(oj))
    held = offs[offs >= 0]

    def free(lanes_offs):
        je.alloc_state = je.ouro.free(
            je.alloc_state, jnp.asarray(lanes_offs), jnp.asarray(sizes),
            jnp.asarray(lanes_offs >= 0))
        te.alloc_state = te.ouro.free(
            te.alloc_state, torch.from_numpy(lanes_offs),
            torch.from_numpy(sizes), torch.from_numpy(lanes_offs >= 0))

    back = np.full(64, -1, np.int32)
    back[:2] = held[:2]
    free(back)
    _submit((je, te), [prompt], 30)
    for _ in range(30):
        assert je.step() == [] and te.step() == []
    assert te.stats["evictions"] == je.stats["evictions"] > 0
    assert len(te.waiting) + sum(r is not None for r in te.slot_req) == 1
    rest = np.full(64, -1, np.int32)
    rest[:len(held) - 2] = held[2:]
    free(rest)
    got = _same_engines(je, te, je.run_until_done(200),
                        te.run_until_done(200))
    host = _port(qwen, False, **kw)
    _submit([host], [prompt], 30)
    assert got == _tokens(host.run_until_done(200))


def test_mega_cancel_of_an_active_slot(qwen):
    """Cancels between steps in lockstep with the reference's mega
    engine: a waiting uid, an active uid (its page-table row freed), the
    same uid again and an unknown one."""
    vocab = get_arch("qwen2-0.5b").smoke().vocab_size
    je, te = _engines(qwen, max_batch=2, max_seq=64)
    _submit((je, te), _prompts(vocab, 4, 5, 6, 7), 4)
    for _ in range(2):
        je.step()
        te.step()
    waiting = [r.uid for r in te.waiting]
    active = sorted(r.uid for r in te.slot_req if r is not None)
    assert len(waiting) == 2 and len(active) == 2
    for uid in (waiting[0], active[0], active[0], 10_000):
        assert je.cancel(uid) == te.cancel(uid)
    done_j, done_t = je.run_until_done(100), te.run_until_done(100)
    got = _same_engines(je, te, done_j, done_t)
    assert set(got) == {1, 2, 3, 4} - {waiting[0], active[0]}
    assert te.stats["cancels"] == 2


def test_mega_mamba2_matches_reference_and_host_loop(mamba):
    """The attention-free family: no grow, the SSM state advanced on
    the device, aux pages granted at admission and freed at retirement
    with the reference's words."""
    vocab = get_arch("mamba2-780m").smoke().vocab_size
    prompts = _prompts(vocab, 4, 2, 4, 40)
    je, te = _engines(mamba, max_batch=2, max_seq=96)
    host = _port(mamba, False, max_batch=2, max_seq=96)
    _submit((je, te, host), prompts, 5)
    got = _same_engines(je, te, je.run_until_done(300),
                        te.run_until_done(300))
    assert got == _tokens(host.run_until_done(300))
    assert te.stats["alloc_txns"] == te.stats["free_txns"] == 4
    assert all(not a.size for a in te.slot_aux)


@pytest.mark.parametrize("mega", (True, False), ids=("mega", "host"))
def test_launches_per_tick_constant_in_batch(qwen, mamba, mega):
    """0 on the CPU (the plain versions run), at max_batch 2 and 8, and
    the engine's state is left as it was."""
    for models in (qwen, mamba):
        counts = []
        for mb in (2, 8):
            e = _port(models, mega, max_batch=mb, max_seq=64)
            mem = e.alloc_state.mem.clone()
            ops.reset_launches()
            counts.append(e.launches_per_tick())
            assert e.stats["launches_per_tick"] == counts[-1]
            assert torch.equal(e.alloc_state.mem, mem)
            assert sum(ops.LAUNCHES.values()) == 0
        assert counts == [0, 0]


def test_launch_cli_mega_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--requests", "3",
                     "--max-new", "4", "--max-batch", "2", "--max-seq", "96",
                     "--mega", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("REQ ") == 3 and "served 3 requests" in out
    assert "'mega_step': True" in out and "'launches_per_tick': 0" in out


def test_mega_under_sustained_pressure_finishes_like_the_host_loop(qwen):
    """``chip_smoke.py``'s pressure run at smoke width: 16 requests of
    16-448 tokens, 32 new each, on 96 pages beside a co-tenant.  Grants
    fail on many ticks and slots are evicted; a slot whose grant failed
    grows before anything is admitted, so the evicted request does not
    take back the pages it freed and the run drains in the host loop's
    steps with its tokens."""
    _, _, tm, tp = qwen
    full = get_arch("qwen2-0.5b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, full.vocab_size, int(rng.integers(16, 449)))
               % tm.cfg.vocab_size for _ in range(16)]
    out = []
    for mega in (False, True):
        e = _port(qwen, mega, max_batch=8, max_seq=512, num_pages=96,
                  defrag_threshold=0.5)
        sizes = torch.full((16,), 2048, dtype=torch.int32)
        e.alloc_state, offs = e.ouro.alloc(e.alloc_state, sizes,
                                           torch.ones(16, dtype=torch.bool))
        e.alloc_state = e.ouro.free(e.alloc_state, offs, sizes, offs >= 0)
        _submit([e], prompts, 32)
        out.append((_tokens(e.run_until_done(200)), e.stats))
    (host, hs), (toks, st) = out
    assert toks == host and len(toks) == 16
    assert st["steps"] <= hs["steps"] + 8
    assert st["alloc_failures"] > 0 and st["defrag_waves"] > 0
    assert st["evictions"] > 0 and st["allocs"] == st["frees"]
