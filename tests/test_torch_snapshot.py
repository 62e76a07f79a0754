"""Crash-safe serving of the port held to the JAX reference.

The contract, as the reference's ``tests/test_serve_snapshot.py`` states
it: ``ServingEngine.snapshot()/restore()`` captures the whole serving
state (arena words and control block of every shard, KV heaps with
their int8 scales, page table and ``seq_lens``, recurrent state rows,
the mega-step's device state and host mirrors, the request queue and
the stats), so a restored engine holds the source's words and finishes
every stream token for token; a snapshot of another layout or geometry
is refused loudly.  Here the port (``device="cpu"``) is also held to the
reference (jnp backend; its blocked lowering fails under this jax):

- the fingerprint equals ``tests/golden/serve_snapshot_fingerprint.txt``
  and the reference's for the same engines, and the snapshot trees have
  the reference's keys, shapes and dtypes (dense, int8, 4 shards, both
  loops, mamba2, the hybrid and the encoder-decoder);
- a reference snapshot (in memory through
  ``models/params.snapshot_from_jax``, and its checkpoint directory)
  restored in the port continues with the reference's tokens, the
  arena and cache words equal to the reference's after restore; a port
  snapshot restored in the reference does the same, in both loops;
- round trips word for word, kill mid-decode and restore, the
  rejections, queue and eviction stats, telemetry and metrics, int8
  pages, 4 shards and mamba2's aux pages, on the port alone.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as JCK
from repro.configs import get_arch as jget
from repro.models.model import build_model as jbuild
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import get_arch
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import MetricsRegistry, validate_exposition
from repro_torch.serve.engine import ServingEngine

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen2():
    cfg = jget("qwen2-0.5b").smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_arch("qwen2-0.5b").smoke()
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


def _port(models, **kw):
    kw.setdefault("kv_dtype", torch.float32)
    return ServingEngine(models[2], models[3], max_batch=3, max_seq=96,
                         compute_dtype=torch.float32, device="cpu", **kw)


def _ref(models, **kw):
    kw.setdefault("kv_dtype", jnp.float32)
    return JEngine(models[0], models[1], max_batch=3, max_seq=96,
                   compute_dtype=jnp.float32, alloc_backend="jnp", **kw)


def _submit(eng, vocab, n=4, max_new=5, seed=0):
    """The reference test's requests (prompts of 4-29 tokens)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        eng.submit(rng.integers(2, vocab, int(rng.integers(4, 30))),
                   max_new_tokens=max_new)


def _toks(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def _words(x):
    """A leaf as comparable host words (bf16 as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        return CK.to_host(x)[0]
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_state(te, ref_tree):
    """The port engine's snapshot leaves equal ``ref_tree``'s (the
    reference's keys), word for word."""
    mine = CK.flatten(te._snapshot_tree())
    ref = JCK._flatten(ref_tree)[0]
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(_words(mine[k]), _words(ref[k]),
                                      err_msg=k)


def _to_reference(snap, je):
    """A port snapshot in the reference's structure (its template's
    keys): numpy leaves, bf16 as ``ml_dtypes`` arrays."""
    import ml_dtypes
    flat = CK.flatten(snap["tree"])
    _, treedef = JCK._flatten(je._snapshot_tree())
    keys = list(JCK._flatten(je._snapshot_tree())[0])

    def leaf(x):
        a, dt = CK.to_host(x)
        return a.view(ml_dtypes.bfloat16) if dt == "bfloat16" else a
    return {"tree": jax.tree_util.tree_unflatten(
        treedef, [leaf(flat[k]) for k in keys]), "meta": snap["meta"]}


# ---- the fingerprint and the tree against the reference -------------------

def test_fingerprint_matches_golden(qwen2):
    eng = _port(qwen2)
    got = json.dumps(eng.snapshot_fingerprint(), indent=2,
                     sort_keys=True) + "\n"
    assert got == (GOLDEN / "serve_snapshot_fingerprint.txt").read_text()


# (arch, KV type, compute type, engine settings, steps before the
# snapshot); every engine computes in its KV type (bf16 beside int8)
TREES = {
    "dense": ("qwen2-0.5b", "float32", "float32", {}, 0),
    "dense-bf16": ("qwen2-0.5b", "bfloat16", "bfloat16", {}, 0),
    "int8": ("qwen2-0.5b", "int8", "bfloat16", {}, 0),
    "mega-S4": ("qwen2-0.5b", "float32", "float32",
                {"mega_step": True, "num_shards": 4}, 0),
    "mamba2": ("mamba2-780m", "bfloat16", "bfloat16", {"mega_step": True},
               0),
    "hybrid": ("recurrentgemma-9b", "bfloat16", "bfloat16", {}, 0),
    "encdec": ("seamless-m4t-large-v2", "bfloat16", "bfloat16", {}, 0),
}
# the port makes an encoder-decoder's cross K/V up front; the reference
# at its first admission (its fresh snapshot has no such leaves)
UP_FRONT = {"caches|.cross_k", "caches|.cross_v", "caches|.enc_valid"}


@pytest.mark.parametrize("case", sorted(TREES))
def test_snapshot_tree_and_fingerprint_match_reference(case):
    """Engines of both packages: equal fingerprints, and snapshot trees
    of the same keys (so either restores the other's directory), shapes
    and dtypes (by numpy's names).  bf16 engines keep their recurrent
    conv tails in bf16 from the start, as the reference's do (float32
    ones promote theirs at the first admission, which the round trips
    below cover); a fresh encoder-decoder of the reference has no cross
    K/V yet, the port's has (``UP_FRONT``)."""
    arch, kv, compute, kw, steps = TREES[case]
    cfg = jget(arch).smoke()
    jm = jbuild(cfg)
    je = JEngine(jm, jm.init(jax.random.PRNGKey(0)), max_batch=2,
                 max_seq=64, kv_dtype=getattr(jnp, kv),
                 compute_dtype=getattr(jnp, compute), **kw)
    tcfg = get_arch(arch).smoke()
    tm = build_model(tcfg)
    te = ServingEngine(tm, tm.init(0, device="cpu"), max_batch=2,
                       max_seq=64, kv_dtype=getattr(torch, kv),
                       compute_dtype=getattr(torch, compute), device="cpu",
                       **kw)
    assert te.snapshot_fingerprint() == je.snapshot_fingerprint()
    for e in (je, te):
        e.submit(np.arange(2, 7, dtype=np.int32), max_new_tokens=3)
        for _ in range(steps):
            e.step()
    mine = CK.flatten(te.snapshot()["tree"])
    ref = JCK._flatten(je.snapshot()["tree"])[0]
    if case == "encdec":
        assert UP_FRONT <= mine.keys() and not UP_FRONT & ref.keys()
        mine = {k: v for k, v in mine.items() if k not in UP_FRONT}
    assert list(mine) == list(ref)
    for k in mine:
        a, b = CK.to_host(mine[k]), np.asarray(ref[k])
        assert (a[0].shape, a[1]) == (b.shape, str(b.dtype)), k


# ---- across the packages: reference <-> port --------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["host", "mega"])
def crossed(request, qwen2, tmp_path_factory):
    """The reference serves the test's requests to the end, snapshotting
    in memory and to disk after 3 steps; the port serves them for 3
    steps and snapshots the same two ways."""
    mega = request.param
    vocab = qwen2[2].cfg.vocab_size
    d = tmp_path_factory.mktemp("cross")
    je = _ref(qwen2, mega_step=mega)
    _submit(je, vocab)
    early_j = []
    for _ in range(3):
        early_j += je.step()
    jsnap = je.snapshot()
    je.snapshot(directory=str(d / "ref"))
    want = _toks(early_j + je.run_until_done(300))
    te = _port(qwen2, mega_step=mega)
    _submit(te, vocab)
    early_t = []
    for _ in range(3):
        early_t += te.step()
    tsnap = te.snapshot()
    te.snapshot(directory=str(d / "port"))
    return dict(je=je, jsnap=jsnap, want=want, early_j=early_j, te=te,
                tsnap=tsnap, early_t=early_t, dir=d, mega=mega)


@pytest.mark.parametrize("source", ["memory", "disk"])
def test_reference_snapshot_continues_in_port(crossed, qwen2, source):
    c = crossed
    dst = _port(qwen2, mega_step=c["mega"])
    mem = dst.alloc_state.mem
    if source == "memory":
        assert dst.restore(P.snapshot_from_jax(c["jsnap"])) is None
    else:
        assert dst.restore(str(c["dir"] / "ref")) == 3
    assert dst.alloc_state.mem is mem          # restored in place
    _same_state(dst, c["jsnap"]["tree"])
    got = _toks(c["early_j"] + dst.run_until_done(300))
    assert got == c["want"]
    assert dst.stats["frees"] == dst.stats["allocs"] > 0
    assert dst.stats["steps"] == c["je"].stats["steps"]


@pytest.mark.parametrize("source", ["memory", "disk"])
def test_port_snapshot_continues_in_reference(crossed, source):
    """The port's snapshot restored into the reference engine (the one
    that served the same requests to the end): it continues with its own
    uninterrupted run's tokens."""
    c = crossed
    je = c["je"]
    if source == "memory":
        je.restore(_to_reference(c["tsnap"], je))
    else:
        assert je.restore(str(c["dir"] / "port")) == 3
    _same_state(c["te"], je._snapshot_tree())
    got = _toks(c["early_t"] + je.run_until_done(300))
    assert got == c["want"]
    assert je.stats["frees"] == je.stats["allocs"]


# ---- the port alone -------------------------------------------------------

def _uninterrupted(models, vocab, **kw):
    ref = _port(models, **kw)
    _submit(ref, vocab)
    return _toks(ref.run_until_done(300))


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mega", [False, True], ids=["host", "mega"])
def test_snapshot_roundtrip_word_for_word(qwen2, shards, mega, tmp_path):
    """Snapshot mid-decode, restore into fresh engines (from memory and
    from disk): every arena, control, KV and page-table word equals the
    source's, and both finish the streams of an uninterrupted run."""
    vocab = qwen2[2].cfg.vocab_size
    kw = dict(num_shards=shards, mega_step=mega)
    want = _uninterrupted(qwen2, vocab, **kw)
    src = _port(qwen2, **kw)
    _submit(src, vocab)
    early = []
    for _ in range(3):
        early += src.step()
    snap = src.snapshot()
    src.snapshot(directory=str(tmp_path))
    for source in (snap, str(tmp_path)):
        dst = _port(qwen2, **kw)
        dst.restore(source)
        mine, theirs = (CK.flatten(e._snapshot_tree()) for e in (dst, src))
        for k in mine:
            np.testing.assert_array_equal(_words(mine[k]),
                                          _words(theirs[k]), err_msg=k)
        assert _toks(early + dst.run_until_done(300)) == want
        assert dst.stats["frees"] == dst.stats["allocs"]


@pytest.mark.parametrize("mega", [False, True], ids=["host", "mega"])
def test_kill_mid_decode_restores_token_identically(qwen2, mega, tmp_path):
    vocab = qwen2[2].cfg.vocab_size
    want = _uninterrupted(qwen2, vocab, mega_step=mega)
    eng = _port(qwen2, mega_step=mega)
    _submit(eng, vocab)
    early = []
    for _ in range(4):
        early += eng.step()
    eng.snapshot(directory=str(tmp_path))
    del eng  # the crash
    resumed = _port(qwen2, mega_step=mega)
    assert resumed.restore(str(tmp_path)) == 4
    assert _toks(early + resumed.run_until_done(300)) == want
    assert resumed.stats["frees"] == resumed.stats["allocs"]


def test_restore_rejects_mismatched_layout(qwen2):
    """A snapshot of another shard count, a tampered layout rendering or
    a leaf of another shape is refused with a ValueError naming it,
    before any engine state changes."""
    src = _port(qwen2, num_shards=1)
    _submit(src, qwen2[2].cfg.vocab_size)
    src.step()
    snap = src.snapshot()
    other = _port(qwen2, num_shards=4)
    ctl_before = other.alloc_state.ctl.clone()
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        other.restore(snap)
    assert torch.equal(other.alloc_state.ctl, ctl_before)

    tampered = {"tree": snap["tree"],
                "meta": json.loads(json.dumps(snap["meta"]))}
    tampered["meta"]["fingerprint"]["arena_layout"] += " (tampered)"
    dst = _port(qwen2)
    with pytest.raises(ValueError, match="arena_layout"):
        dst.restore(tampered)

    short = dict(snap["tree"], slot_len=snap["tree"]["slot_len"][:2])
    mem_before = dst.alloc_state.mem.clone()
    with pytest.raises(ValueError, match="slot_len"):
        dst.restore({"tree": short, "meta": snap["meta"]})
    assert torch.equal(dst.alloc_state.mem, mem_before)


def test_restore_rejects_non_snapshot_checkpoint(qwen2, tmp_path):
    """A plain checkpoint (no fingerprint sidecar), the port's or the
    reference's, is refused, not misread."""
    CK.save({"w": torch.zeros(4)}, str(tmp_path / "port"), step=1)
    JCK.save({"w": jnp.zeros(4)}, str(tmp_path / "ref"), step=1)
    eng = _port(qwen2)
    for d in ("port", "ref"):
        with pytest.raises(ValueError, match="not a serving-engine"):
            eng.restore(str(tmp_path / d))


def test_snapshot_carries_queue_and_eviction_stats(qwen2):
    eng = _port(qwen2)
    _submit(eng, qwen2[2].cfg.vocab_size, n=6)  # 6 requests > 3 slots
    eng.step()
    eng.stats["evictions"] = 2  # as if the killed run had degraded
    snap = eng.snapshot()
    dst = _port(qwen2)
    dst.restore(snap)
    assert dst.stats["evictions"] == 2
    assert len(dst.waiting) == len(eng.waiting) > 0
    assert [r and r.uid for r in dst.slot_req] == \
        [r and r.uid for r in eng.slot_req]
    assert sorted(_toks(dst.run_until_done(300))) == list(range(1, 7))


def test_snapshot_roundtrips_telemetry_and_metrics(qwen2):
    src = _port(qwen2)
    _submit(src, qwen2[2].cfg.vocab_size)
    for _ in range(3):
        src.step()
    tele_src = src.drain_telemetry()
    assert int(tele_src["t_alloc"].sum()) > 0
    dst = _port(qwen2)
    dst.restore(src.snapshot())
    tele_dst = dst.drain_telemetry()
    assert sorted(tele_src) == sorted(tele_dst)
    for field in tele_src:
        np.testing.assert_array_equal(tele_src[field], tele_dst[field],
                                      err_msg=field)
    text_src = src.publish_metrics(MetricsRegistry()).to_prometheus()
    text_dst = dst.publish_metrics(MetricsRegistry()).to_prometheus()
    validate_exposition(text_src)
    for fam in ("repro_alloc_granted_total", "repro_free_total",
                "repro_alloc_failed_total", "repro_engine_allocs_total",
                "repro_engine_steps_total"):
        pick = [ln for ln in text_src.splitlines() if ln.startswith(fam)]
        assert pick == [ln for ln in text_dst.splitlines()
                        if ln.startswith(fam)], fam
    dst.run_until_done(300)
    assert int(dst.drain_telemetry()["t_alloc"].sum()) >= \
        int(tele_dst["t_alloc"].sum())


@pytest.mark.parametrize("mega", [False, True], ids=["host", "mega"])
def test_int8_kv_pages_roundtrip(qwen2, mega, tmp_path):
    """int8 pages and their float32 scales go to disk as the reference
    records them and come back word for word; the streams finish as an
    uninterrupted int8 run's."""
    vocab = qwen2[2].cfg.vocab_size
    kw = dict(kv_dtype=torch.int8, mega_step=mega)
    want = _uninterrupted(qwen2, vocab, **kw)
    src = _port(qwen2, **kw)
    _submit(src, vocab)
    early = []
    for _ in range(3):
        early += src.step()
    src.snapshot(directory=str(tmp_path))
    meta, _ = CK.read_meta(str(tmp_path))
    dtypes = {k: v["dtype"] for k, v in meta["leaves"].items()}
    assert dtypes["caches|.kv|.layers|.k"] == "int8"
    assert dtypes["caches|.kv|.layers|.k_scale"] == "float32"
    assert meta["extra"]["fingerprint"]["kv_dtype"] == "int8"
    dst = _port(qwen2, **kw)
    dst.restore(str(tmp_path))
    assert torch.any(dst.caches.kv.layers.k_scale != 0)
    for k, v in CK.flatten(src._snapshot_tree()).items():
        np.testing.assert_array_equal(
            _words(v), _words(CK.flatten(dst._snapshot_tree())[k]), err_msg=k)
    assert _toks(early + dst.run_until_done(300)) == want


@pytest.mark.parametrize("mega", [False, True], ids=["host", "mega"])
def test_mamba2_aux_pages_roundtrip(mega, tmp_path):
    """mamba2's SSM state rows and each slot's aux page ids survive a
    snapshot on disk; the restored engine frees exactly those pages."""
    cfg = get_arch("mamba2-780m").smoke()
    m = build_model(cfg)
    params = m.init(0, device="cpu")

    def make():
        return ServingEngine(m, params, max_batch=2, max_seq=64,
                             kv_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu",
                             mega_step=mega)
    ref = make()
    _submit(ref, cfg.vocab_size, n=3, max_new=4, seed=1)
    want = _toks(ref.run_until_done(300))
    src = make()
    _submit(src, cfg.vocab_size, n=3, max_new=4, seed=1)
    early = src.step() + src.step()
    assert src.aux_pages > 0 and any(len(a) for a in src.slot_aux)
    src.snapshot(directory=str(tmp_path))
    dst = make()
    dst.restore(str(tmp_path))
    assert [a.tolist() for a in dst.slot_aux] == \
        [a.tolist() for a in src.slot_aux]
    assert torch.equal(dst.caches.ssm_h, src.caches.ssm_h)
    assert _toks(early + dst.run_until_done(300)) == want
    assert dst.stats["frees"] == dst.stats["allocs"]
    assert not any(len(a) for a in dst.slot_aux)
