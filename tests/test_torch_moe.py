"""The port's MoE family (mixtral-8x7b, phi3.5-moe) and its sliding
window held to the JAX reference on the CPU.

Inputs come from numpy with a seed; parameters from the reference
``Model.init`` through ``params_from_jax``.  Everything runs float32:

- ``apply_moe`` within atol 1e-5 (the same products summed in another
  order), at decode (S = 1, ``no_drop``) and prefill, where capacity
  drops pairs, and with a router whose columns repeat (ties go to the
  lower expert, as ``jax.lax.top_k`` breaks them).  Its inputs have std
  0.05-0.1, so that its outputs are O(1): at unit inputs the reference's
  init (std 1/sqrt(layers)) drives them into the hundreds, where
  float32 rounds at 3e-5;
- ``flash_attention`` with a window, ``paged_attend1`` with a window and
  with a ring table shorter than the sequence: atol 1e-5 (the reference
  folds 16 pages a step, the port one);
- ``append1``/``prefill_write1`` through ring tables: word for word;
- smoke prefill and decode logits: atol 5e-4, and the K/V heaps within
  1e-4 of their largest magnitude: the reference's init drives each
  MoE layer's output into the hundreds, and its float32 roundings
  (5e-4 there) reach the next layer's K/V and the logits (measured: up
  to 1.8e-4 on logits of magnitude 3, 3e-5 of the heaps' largest
  magnitude);
- the engine, host loop and mega-step, against the reference's on
  prompts longer than the smoke config's 64-token window: the same
  tokens per uid, page and aux page ids after every step, stats and
  arena words.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro.paged import kv_cache as jkv
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers, moe
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine

ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
ATOL = 1e-5
LOGIT_ATOL = 5e-4
HEAP_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    cfg = jget(arch).smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_arch(arch).smoke()
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def mixtral():
    return _models("mixtral-8x7b")


@pytest.fixture(scope="module")
def phi():
    return _models("phi3.5-moe-42b-a6.6b")


# ---- configs, parameters, page quota ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for full in (True, False):
        a, b = jget(arch), get_arch(arch)
        if not full:
            a, b = a.smoke(), b.smoke()
        fa = dataclasses.asdict(a)
        for k, v in dataclasses.asdict(b).items():
            assert fa[k] == v, k
        # the reference's other fields belong to the hybrid family
        assert set(fa) - set(dataclasses.asdict(b)) == {"lru_width",
                                                        "local_window"}
    sm = get_arch(arch).smoke()
    assert (sm.num_layers, sm.d_model, sm.num_experts,
            sm.num_experts_per_tok, sm.d_ff) == (2, 128, 4, 2, 256)
    assert sm.sliding_window == (64 if arch.startswith("mixtral") else None)


def test_check_supported_accepts_moe_and_refuses_the_rest():
    for arch in ARCHS:
        P.check_supported(get_arch(arch))
        P.check_supported(get_arch(arch).smoke())
    for arch in ("recurrentgemma-9b", "seamless-m4t-large-v2",
                 "qwen2-vl-2b", "command-r-35b"):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            P.check_supported(jget(arch))


@pytest.mark.parametrize("arch,want", [("mixtral-8x7b", 7168),
                                       ("phi3.5-moe-42b-a6.6b", 3200)])
def test_modality_page_quota_matches_reference(arch, want):
    assert KV.modality_page_quota(get_arch(arch)) == want
    assert jkv.modality_page_quota(jget(arch)) == want
    assert KV.modality_page_quota(get_arch(arch).smoke()) == 8 == \
        jkv.modality_page_quota(jget(arch).smoke())
    with pytest.raises(NotImplementedError, match="A12"):
        KV.modality_page_quota(jget("recurrentgemma-9b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_shapes_and_scales(arch, mixtral, phi):
    cfg = get_arch(arch).smoke()
    mine = P.init(cfg, 0)
    conv = (mixtral if arch.startswith("mixtral") else phi)[3]
    assert mine.keys() == conv.keys() == {"embed", "final_norm", "blocks",
                                          "lm_head"}
    for bm, bc in zip(mine["blocks"], conv["blocks"]):
        for grp in bc:
            assert bm[grp].keys() == bc[grp].keys()
            for nm in bc[grp]:
                assert bm[grp][nm].shape == bc[grp][nm].shape, (grp, nm)
    assert mine["blocks"][0]["ffn"]["w_gate"].shape == (4, 128, 256)
    assert mine["lm_head"].shape == conv["lm_head"].shape == (
        128, cfg.padded_vocab)
    w = torch.stack([b["ffn"]["w_up"] for b in mine["blocks"]])
    assert abs(float(w.std()) - cfg.num_layers ** -0.5) < 0.05
    assert abs(float(mine["lm_head"].std()) - 128 ** -0.5) < 0.01
    half = P.init(cfg, 0, dtype=torch.bfloat16)
    assert half["blocks"][0]["ffn"]["router"].dtype == torch.bfloat16
    torch.testing.assert_close(half["lm_head"],
                               mine["lm_head"].to(torch.bfloat16))


# ---- apply_moe --------------------------------------------------------------

def _layer0(models):
    jm, jp, tm, tp = models
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["ffn"])
    return jm.cfg, tm.cfg, pj, tp["blocks"][0]["ffn"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ("decode", "prefill"))
def test_apply_moe_matches_reference(arch, mode, mixtral, phi):
    jcfg, cfg, pj, pt = _layer0(mixtral if arch.startswith("mixtral")
                                else phi)
    rng = np.random.default_rng(len(arch))
    S, no_drop = (1, True) if mode == "decode" else (40, False)
    x = 0.05 * rng.standard_normal((3, S, cfg.d_model)).astype(np.float32)
    if mode == "prefill":
        # inputs with a common part that the router's column 0 reads:
        # most tokens pick expert 0 and its buffer overflows
        x += 0.01
        r = np.asarray(pj["router"]).copy()
        r[:, 0] += 4.0
        pj = dict(pj, router=jnp.asarray(r))
        pt = dict(pt, router=torch.from_numpy(r))
    jy, jaux = jmoe.apply_moe(jcfg, pj, jnp.asarray(x), no_drop=no_drop)
    ty, taux = moe.apply_moe(cfg, pt, torch.from_numpy(x), no_drop=no_drop)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL)
    _, topi, _ = moe.route(cfg, pt["router"], torch.from_numpy(x))
    cap = moe.capacity(cfg, S, no_drop)
    per = torch.nn.functional.one_hot(topi.reshape(3, -1),
                                      cfg.num_experts).sum(1)
    dropped = int(torch.clamp(per - cap, min=0).sum())
    assert (dropped > 0) == (mode == "prefill"), dropped


def test_tied_router_picks_the_lower_expert(mixtral):
    """Router columns 0, 1 and 2 equal: every token's logits for experts
    0-2 tie; both sides keep the lower experts of a tie first (expert 2
    is never picked), so the experts, their weights and the output
    agree."""
    jcfg, cfg, pj, pt = _layer0(mixtral)
    r = np.asarray(pj["router"]).copy()
    r[:, 1] = r[:, 2] = r[:, 0]
    pj = dict(pj, router=jnp.asarray(r))
    pt = dict(pt, router=torch.from_numpy(r))
    x = 0.1 * np.random.default_rng(7).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    probs, topi, topw = moe.route(cfg, pt["router"], torch.from_numpy(x))
    assert torch.equal(probs[..., 0], probs[..., 1])
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(r), axis=-1)
    jw, ji = jax.lax.top_k(jprobs, cfg.num_experts_per_tok)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        topw.numpy(), np.asarray(jw / (jw.sum(-1, keepdims=True) + 1e-9)),
        atol=1e-6)
    assert set(np.unique(topi.numpy())) == {0, 1, 3}
    jy, _ = jmoe.apply_moe(jcfg, pj, jnp.asarray(x), no_drop=False)
    ty, _ = moe.apply_moe(cfg, pt, torch.from_numpy(x), no_drop=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


# ---- the window: prefill attention, ring writes, paged decode -------------

@pytest.mark.parametrize("window,block", [(9, 16), (64, 16), (200, 512)])
def test_flash_attention_window_matches_reference(window, block):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    want = jlayers.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True, window=window, block=block)
    got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, window=window, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ring_writes_match_reference():
    """``prefill_write1`` from position 50 through a 4-slot ring (pages
    3 and 4 land in slots 3 and 0) and ``append1`` at lengths that wrap,
    with holes: the reference's heaps word for word."""
    rng = np.random.default_rng(5)
    B, S, Hkv, D, page, Pn, NP = 3, 20, 2, 8, 16, 4, 14
    table = rng.permutation(NP)[:B * Pn].reshape(B, Pn).astype(np.int32)
    table[1, 0] = -1
    k0 = rng.standard_normal((NP, page, Hkv, D)).astype(np.float32)
    jl = jkv.KVLayer(k=jnp.asarray(k0), v=jnp.asarray(k0 + 1), k_scale=None,
                     v_scale=None)
    tl = KV.KVLayer(torch.from_numpy(k0.copy()),
                    torch.from_numpy(k0 + 1))
    kp = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jl = jkv.prefill_write1(jl, jnp.asarray(table), jnp.asarray(kp),
                            jnp.asarray(-kp), pos0=50, ring=True)
    KV.prefill_write1(tl, torch.from_numpy(table), torch.from_numpy(kp),
                      torch.from_numpy(-kp), pos0=50, ring=True)
    for lens in ([70, 5, 63], [64, 16, 200]):
        kt = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        jl = jkv.append1(jl, jnp.asarray(table),
                         jnp.asarray(np.array(lens, np.int32)),
                         jnp.asarray(kt), jnp.asarray(2 * kt), ring=True)
        KV.append1(tl, torch.from_numpy(table),
                   torch.tensor(lens, dtype=torch.int32),
                   torch.from_numpy(kt), torch.from_numpy(2 * kt), ring=True)
    np.testing.assert_array_equal(tl.k.numpy(), np.asarray(jl.k))
    np.testing.assert_array_equal(tl.v.numpy(), np.asarray(jl.v))
    assert not np.array_equal(tl.k.numpy(), k0)


@pytest.mark.parametrize("ring", (False, True), ids=("window", "ring"))
def test_paged_attend1_window_and_ring_match_reference(ring):
    """Decode attention with a 40-token window; with ``ring`` through a
    table of 5 slots, shorter than the 20 pages the longest row has
    written (the ring wraps), with holes."""
    rng = np.random.default_rng(11)
    B, Hq, Hkv, D, page, NP, window = 4, 8, 2, 32, 16, 90, 40
    Pn = 5 if ring else 20
    seq = np.array([1, 37, 80, 320] if ring else [1, 37, 200, 320],
                   np.int32)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((NP, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((NP, page, Hkv, D)).astype(np.float32)
    table = rng.permutation(NP)[:B * Pn].reshape(B, Pn).astype(np.int32)
    table[2, 1] = -1
    layer = jkv.KVLayer(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=None,
                        v_scale=None)
    want = np.asarray(jkv.paged_attend1(layer, jnp.asarray(table),
                                        jnp.asarray(seq), jnp.asarray(q),
                                        window=window, ring=ring))
    tt = torch.from_numpy(table)
    got = KV.paged_attend1(KV.KVLayer(torch.from_numpy(k),
                                      torch.from_numpy(v)), tt,
                           torch.from_numpy(seq), torch.from_numpy(q),
                           window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    full = KV.paged_attend1(KV.KVLayer(torch.from_numpy(k),
                                       torch.from_numpy(v)), tt,
                            torch.from_numpy(seq), torch.from_numpy(q))
    assert float((full - got).abs().max()) > 1e-3


# ---- the model ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, mixtral, phi):
    """A 70-token prefill (past mixtral's 64-token smoke window) and
    three decode steps through shuffled page tables."""
    jm, jp, m, tp = mixtral if arch.startswith("mixtral") else phi
    cfg = m.cfg
    B, S, max_seq = 2, 70, 128
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = rng.permutation(B * 8).astype(np.int32).reshape(B, 8)
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    jc = jc._replace(kv=jc.kv._replace(page_table=jnp.asarray(table)))
    tc = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                              device="cpu")
    tc.kv.page_table.copy_(torch.from_numpy(table))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                       dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for step in range(3):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, torch.from_numpy(nt).long(), tc,
                               dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
    for mine, want in ((tc.kv.layers.k, jc.kv.layers.k),
                       (tc.kv.layers.v, jc.kv.layers.v)):
        want = np.asarray(want)
        err = float(np.abs(mine.numpy() - want).max())
        assert err <= HEAP_REL * float(np.abs(want).max()), err


# ---- the serving engine ----------------------------------------------------

PROMPT_LENS = (70, 9, 90, 33)


def _prompts(cfg, lens=PROMPT_LENS):
    rng = np.random.default_rng(len(lens))
    return [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _engines(models, mega, **kw):
    jm, jp, tm, tp = models
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=mega, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


def _serve_in_lockstep(je, te, prompts, max_new, max_steps=200):
    for p in prompts:
        assert je.submit(p, max_new) == te.submit(p, max_new)
    got = ({}, {})
    for step in range(max_steps):
        for e, out in zip((je, te), got):
            for r in e.step():
                out[r.uid] = list(map(int, r.out_tokens))
        assert [list(map(int, a)) for a in te.slot_aux] == \
            [[int(p) for p in a] for a in je.slot_aux], f"step {step}"
        assert [list(map(int, a)) for a in te.slot_pages] == \
            [[int(p) for p in a] for a in je.slot_pages], f"step {step}"
        np.testing.assert_array_equal(te.caches.kv.page_table.numpy(),
                                      np.asarray(je.caches.kv.page_table))
        if not te.waiting and all(r is None for r in te.slot_req):
            break
    assert not je.waiting and all(r is None for r in je.slot_req)
    return got


def _check_same(je, te):
    shared = set(je.stats) & set(te.stats)
    assert {"allocs", "frees", "alloc_txns", "aux_pages_per_slot",
            "steps"} <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    np.testing.assert_array_equal(te.alloc_state.mem.numpy(),
                                  np.asarray(je.alloc_state.mem))
    np.testing.assert_array_equal(te.alloc_state.ctl.numpy(),
                                  np.asarray(je.alloc_state.ctl))
    assert te.stats["allocs"] == te.stats["frees"] > 0
    assert bool((te.caches.kv.page_table == -1).all())


@pytest.mark.parametrize("max_batch", (2, 3))
def test_engine_matches_reference_host_loop(mixtral, max_batch):
    """Prompts of up to 90 tokens and 12 new each, past the 64-token
    window in prefill and in decode; 8 aux pages a slot."""
    je, te = _engines(mixtral, False, max_batch=max_batch, max_seq=128)
    assert te.aux_pages == je.aux_pages == 8
    jt, tt = _serve_in_lockstep(je, te, _prompts(te.cfg), 12)
    assert tt == jt and len(tt) == len(PROMPT_LENS)
    _check_same(je, te)


def test_mega_step_matches_reference_mega_step(mixtral, monkeypatch):
    """``mega_step=True`` against the reference's: the same tokens, page
    and aux ids, stats and words, and the host loop's tokens.  A tick is
    one grow and one ``paged_attention`` a layer: the port's counters
    see ``1 + num_layers`` calls (each dispatch counted here as its
    kernel's wrapper counts a launch on the card)."""
    je, te = _engines(mixtral, True, max_batch=2, max_seq=128)
    jt, tt = _serve_in_lockstep(je, te, _prompts(te.cfg), 12)
    assert tt == jt
    _check_same(je, te)
    host = ServingEngine(mixtral[2], mixtral[3], max_batch=2, max_seq=128,
                         kv_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu")
    for p in _prompts(host.cfg):
        host.submit(p, 12)
    assert {r.uid: list(r.out_tokens) for r in host.run_until_done()} == tt
    for name in ("paged_attention", "arena_alloc_txn"):
        plain = getattr(ops, name)

        def counted(*a, _plain=plain, _name=name.replace("arena_", ""),
                    **kw):
            ops.count(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    for mega in (True, False):
        e = ServingEngine(mixtral[2], mixtral[3], max_batch=3, max_seq=128,
                          kv_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu",
                          mega_step=mega)
        e.submit(_prompts(e.cfg)[0], 4)
        e.step()
        ops.reset_launches()
        assert e.launches_per_tick() == 1 + e.cfg.num_layers == 3
        assert ops.LAUNCHES["alloc_txn"] == 1
        assert ops.LAUNCHES["paged_attention"] == e.cfg.num_layers


def test_launch_cli_serves_mixtral_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "mixtral-8x7b", "--smoke", "--requests", "3",
                     "--max-new", "4", "--max-batch", "2", "--max-seq",
                     "96", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("REQ ") == 3
    assert "'aux_pages_per_slot': 8" in out
