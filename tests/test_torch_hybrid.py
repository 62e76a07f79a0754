"""The port's hybrid family (recurrentgemma-9b: RG-LRU blocks and local
attention) held to the JAX reference on the CPU.

Inputs come from numpy with a seed; parameters from the reference
``Model.init`` through ``params_from_jax``; the smoke config is one
(rec, rec, attn) triple and one tail block, R 128, window 64.  Every
comparison runs float32.  Tolerances:

- ``linear_scan`` against ``jax.lax.associative_scan``: atol 1e-6 +
  rtol 1e-5 (the same products and sums associated in another order;
  |h| stays below about 3 here);
- GeGLU: atol 1e-5 (and more than 1e-4 from PyTorch's exact GeLU), at
  inputs of std 0.1: the reference's init (std 1 for one stacked
  layer) drives unit inputs' outputs into the thousands, where float32
  rounds at 5e-4;
- ``apply_rglru_layer`` at prefill (S 1, 3, 37, 130) and three decode
  steps on its state: outputs, state and conv tail within LAYER_REL
  (5e-5) of their largest magnitude;
- the model's logits at prefill (70 tokens, past the window) and three
  decode steps: atol 5e-4 (logits of magnitude 3); the recurrent state
  rows (``ssm_h``, ``ssm_conv``) row by row and the K/V heaps within
  HEAP_REL (5e-4) of their largest magnitude after the prefill, the
  state rows within STATE_REL (2e-3) after each decode step.  The RG-LRU is
  ill-conditioned at the reference's init: sqrt(1 - a_t^2) at a_t near
  1 (17% of a_t above 0.9999 here) multiplies a rounding of a_t by
  1 / (1 - a_t^2), so two float32 evaluations part far more than one
  rounding.  Measured: both layers' outputs are 3.0e-3 from a float64
  evaluation at S 37 (magnitude 63), and a relative perturbation of
  1e-7 of the embedding alone moves the smoke model's heaps by 2.5e-5
  and its states by 5.5e-5 of their largest magnitude (the two
  packages part by 3.5e-4 and 1.8e-4 there, up to 2.6e-4 on logits).
  At decode an a_t that rounds to 1.0 on one side and to 1 - 2^-24 on
  the other moves sqrt(max(1 - a_t^2, 1e-12)) from 1e-6 to 3.5e-4:
  the tail row's state parts by 0.080 at magnitude 63 after the second
  step, where that perturbation alone moves it by 0.011;
- the same at 8 layers (two triples and two tail blocks, where the
  state layout is not the layer order): logits atol DEEP_LOGIT_ATOL
  (2e-3), the state rows within DEEP_STATE_REL (4e-3) of their largest
  magnitude after the prefill and each decode step, the heaps within
  HEAP_REL.  Measured: both packages' prefill logits are 1.0e-2 from a
  float64 evaluation of the port (4 layers: 3.7e-3 and 3.9e-3) and part
  by 8.1e-4; the state rows part by up to 1.6e-3 of their largest
  magnitude; any two rows lie 0.64 of it apart;
- the engine, host loop and mega-step: the reference's tokens per uid,
  KV and aux page ids after every step, stats and arena words, with
  ``allocs == frees``, on plain traffic, through the reference replay
  harness's abandonment trace (cancels) and through a requeue at
  admission (a co-tenant leaves room for one slot's aux pages).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models.model import build_model as jbuild
from repro.paged import kv_cache as jkv
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.replay import SCENARIOS, TraceItem, generate_trace

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers, rglru
from repro_torch.models import params as P
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine

ARCH = "recurrentgemma-9b"
SCAN_TOL = dict(atol=1e-6, rtol=1e-5)
ATOL = 1e-5
LAYER_REL = 5e-5
LOGIT_ATOL = 5e-4
HEAP_REL = 5e-4
STATE_REL = 2e-3
DEEP_LOGIT_ATOL = 2e-3
DEEP_STATE_REL = 4e-3


def _close_to_scale(got, want, rel, msg=""):
    """|got - want| <= rel * max|want|, elementwise."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (msg, err)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(num_layers=None):
    """The reference model and its port, with the port's parameters
    converted from the reference's ``Model.init`` tree; ``num_layers``
    replaces the smoke config's depth in both packages."""
    cfg, tcfg = jget(ARCH).smoke(), get_arch(ARCH).smoke()
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def models():
    return _pair()


# ---- configs, parameters, page quota ---------------------------------------

def test_config_copy_matches_reference():
    for full in (True, False):
        a, b = jget(ARCH), get_arch(ARCH)
        if not full:
            a, b = a.smoke(), b.smoke()
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert set(fa) == set(fb)
        assert fa == fb
    full = get_arch(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim_, full.d_ff, full.lru_width,
            full.local_window, full.act) == (38, 4096, 16, 1, 256, 12288,
                                             4096, 2048, "gelu")
    sm = full.smoke()
    assert (sm.num_layers, sm.lru_width, sm.local_window) == (4, 128, 64)
    assert TF.num_attn_layers(full) == 12 and TF.num_rec_layers(full) == 26
    assert P.hybrid_counts(full) == (12, 2)


def test_check_supported_accepts_hybrid_and_refuses_the_rest():
    for cfg in (get_arch(ARCH), get_arch(ARCH).smoke()):
        P.check_supported(cfg)
    # every reference config is supported now; a logit softcap, which
    # none sets, is still refused
    from repro.configs import ALL_ARCHS
    for arch in ALL_ARCHS:
        P.check_supported(jget(arch))
    with pytest.raises(NotImplementedError, match="logit_softcap"):
        P.check_supported(dataclasses.replace(jget(ARCH),
                                              logit_softcap=30.0))
    bad = dataclasses.replace(get_arch(ARCH).smoke(), attn_period=4)
    with pytest.raises(NotImplementedError, match="attn_period"):
        P.check_supported(bad)


@pytest.mark.parametrize("full", (True, False), ids=("full", "smoke"))
def test_modality_page_quota_matches_reference(full):
    cfg, jcfg = get_arch(ARCH), jget(ARCH)
    if not full:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    want = 4160 if full else 15      # 26 (resp. 3) layers x 10 R bytes
    assert KV.modality_page_quota(cfg) == want == \
        jkv.modality_page_quota(jcfg)


def test_params_from_jax_unstacks_triples_and_tail(models):
    jm, jp, m, tp = models
    assert tp.keys() == {"triples", "tail", "embed", "final_norm",
                         "lm_head"}
    assert len(tp["triples"]) == 1 and len(tp["tail"]) == 1
    assert tp["triples"][0].keys() == {"rec1", "rec2", "attn"}
    for name in ("rec1", "rec2", "attn"):
        for grp, leaves in jp["triples"][name].items():
            for nm, arr in leaves.items():
                np.testing.assert_array_equal(
                    tp["triples"][0][name][grp][nm].numpy(),
                    np.asarray(arr)[0])
    for grp, leaves in jp["tail"].items():
        for nm, arr in leaves.items():
            np.testing.assert_array_equal(tp["tail"][0][grp][nm].numpy(),
                                          np.asarray(arr)[0])


def test_init_matches_reference_shapes_and_scales(models):
    cfg = get_arch(ARCH).smoke()
    mine, conv = P.init(cfg, 0), models[3]
    assert mine.keys() == conv.keys()

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree
    a, b = dict(leaves(mine)), dict(leaves(conv))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    mix = mine["triples"][0]["rec1"]["mixer"]
    assert bool((mix["lambda_p"] == 1.0).all())
    assert bool((mix["conv_b"] == 0).all())
    # fan-in of the stacked spec: 1 triple and 1 tail block at smoke
    # width, 12 and 2 at full width
    full = get_arch(ARCH)
    big = dataclasses.replace(full, d_model=256, d_ff=256, lru_width=256,
                              num_heads=2, head_dim=64, vocab_size=512)
    w = P.init(big, 0)
    for blocks, n in ((w["triples"], 12), (w["tail"], 2)):
        mixers = [(b["rec1"] if "rec1" in b else b)["mixer"] for b in blocks]
        x = torch.stack([mx["w_out"] for mx in mixers])
        assert abs(float(x.std()) - n ** -0.5) < 0.05 * n ** -0.5, n
        cw = torch.stack([mx["conv_w"] for mx in mixers])
        assert abs(float(cw.std()) - 0.5 * n ** -0.5) < 0.1 * n ** -0.5
    half = P.init(cfg, 0, dtype=torch.bfloat16)
    hm = half["triples"][0]["rec1"]["mixer"]
    assert hm["w_out"].dtype == torch.bfloat16
    for nm in ("w_input_gate", "w_rec_gate", "lambda_p"):
        assert hm[nm].dtype == torch.float32, nm
    cast = P.cast_for_compute(half, torch.bfloat16)
    cm = cast["tail"][0]["mixer"]
    assert cm["w_rec_gate"].dtype == torch.float32
    assert cm["w_gate_branch"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.bfloat16  # as drawn
    assert P.cast_for_compute(mine, torch.bfloat16)["final_norm"][
        "scale"].dtype == torch.float32


# ---- GeGLU, the scan, the RG-LRU layer -------------------------------------

def test_geglu_matches_reference(models):
    jm, jp, m, tp = models
    cfg, jcfg = m.cfg, jm.cfg
    pj = jax.tree.map(lambda a: a[0], jp["triples"]["attn"]["ffn"])
    pt = tp["triples"][0]["attn"]["ffn"]
    x = 0.1 * np.random.default_rng(4).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(jcfg, pj, jnp.asarray(x)))
    got = layers.apply_mlp(cfg, pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the trap: PyTorch's default GeLU is the exact one
    h = torch.from_numpy(x) @ pt["w_gate"]
    exact = (F.gelu(h) * (torch.from_numpy(x) @ pt["w_up"])) @ pt["w_down"]
    assert float((exact - got).abs().max()) > 1e-4


@pytest.mark.parametrize("S", (1, 3, 37, 130, 4160))
def test_linear_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 64)).astype(np.float32)
    b = rng.standard_normal((2, S, 64)).astype(np.float32) * 0.3

    def combine(lhs, rhs):
        return rhs[0] * lhs[0], rhs[0] * lhs[1] + rhs[1]
    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    # against the sequential recurrence in float64
    h, seq = np.zeros((2, 64)), []
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), **SCAN_TOL)


@pytest.mark.parametrize("S", (1, 3, 37, 130))
def test_rglru_layer_prefill_and_decode_match_reference(models, S):
    """A prefill of S tokens (shorter than the conv width, and past the
    window), then three decode steps carrying (h, conv tail)."""
    jm, jp, m, tp = models
    cfg, jcfg = m.cfg, jm.cfg
    pj = jax.tree.map(lambda a: a[0], jp["triples"]["rec2"]["mixer"])
    pt = tp["triples"][0]["rec2"]["mixer"]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jy, (jh, jc) = jrglru.apply_rglru_layer(jcfg, pj, jnp.asarray(x))
    ty, (th, tc) = rglru.apply_rglru_layer(cfg, pt, torch.from_numpy(x))
    assert th.dtype == torch.float32 and th.shape == (2, cfg.lru_width)
    assert tc.shape == (2, 3, cfg.lru_width)
    for got, want, what in ((ty, jy, "y"), (th, jh, "h"), (tc, jc, "conv")):
        _close_to_scale(got, want, LAYER_REL, f"prefill {what}")
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, (jh, jc) = jrglru.apply_rglru_layer(jcfg, pj, jnp.asarray(xt),
                                                (jh, jc))
        ty, (th, tc) = rglru.apply_rglru_layer(cfg, pt, torch.from_numpy(xt),
                                               (th, tc))
        for got, want, what in ((ty, jy, "y"), (th, jh, "h"),
                                (tc, jc, "conv")):
            _close_to_scale(got, want, LAYER_REL, f"decode {step} {what}")


# ---- the model ------------------------------------------------------------

@pytest.mark.parametrize("num_layers", (4, 8))
def test_prefill_and_decode_logits_match_reference(models, num_layers):
    """A 70-token prefill (past the 64-token smoke window) and three
    decode steps through shuffled page tables: logits, the recurrent
    state rows in the reference's layout, and the K/V heaps.  At 4
    layers (one triple and one tail block) that layout is the layer
    order; at 8 (two triples and two tail blocks) it is not: rows 0-1
    hold the triples' first recurrent layers, 2-3 their second, 4-5 the
    tail."""
    jm, jp, m, tp = models if num_layers == 4 else _pair(num_layers)
    cfg = m.cfg
    n_rec, n_attn = TF.num_rec_layers(cfg), TF.num_attn_layers(cfg)
    assert (n_rec, n_attn) == ((3, 1) if num_layers == 4 else (6, 2))
    logit_atol, prefill_rel, state_rel = (
        (LOGIT_ATOL, HEAP_REL, STATE_REL) if num_layers == 4
        else (DEEP_LOGIT_ATOL, DEEP_STATE_REL, DEEP_STATE_REL))
    B, S, max_seq = 2, 70, 128
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = rng.permutation(B * 8).astype(np.int32).reshape(B, 8)
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    jc = jc._replace(kv=jc.kv._replace(page_table=jnp.asarray(table)))
    tc = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                              device="cpu")
    assert tc.ssm_h.shape == jc.ssm_h.shape == (n_rec, B, 128)
    assert tc.ssm_conv.shape == jc.ssm_conv.shape == (n_rec, B, 3, 128)
    assert tc.kv.layers.k.shape[0] == n_attn
    tc.kv.page_table.copy_(torch.from_numpy(table))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                       dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=logit_atol)

    def same_state(what, rel):
        for i in range(n_rec):   # the triples' rec1, their rec2, the tail
            for got, want in ((tc.ssm_h, jc.ssm_h),
                              (tc.ssm_conv, jc.ssm_conv)):
                _close_to_scale(got[i], want[i], rel,
                                f"{what}: state row {i}")
    same_state("prefill", prefill_rel)
    for step in range(3):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, torch.from_numpy(nt).long(), tc,
                               dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=logit_atol,
                                   err_msg=f"decode step {step}")
        same_state(f"decode step {step}", state_rel)
    for mine, want in ((tc.kv.layers.k, jc.kv.layers.k),
                       (tc.kv.layers.v, jc.kv.layers.v)):
        _close_to_scale(mine, want, HEAP_REL, "K/V heaps")
    # each row holds its own layer's state, far apart from every other
    # row's, so the row-by-row check above fails for any other layout
    want = np.asarray(jc.ssm_h)
    for i in range(n_rec):
        for j in range(i):
            gap = float(np.abs(want[i] - want[j]).max())
            assert gap > 2 * state_rel * float(np.abs(want).max()), (i, j)
    # Caches() with KV only: the states come back freshly stacked
    kv_only = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                                   device="cpu")._replace(ssm_h=None,
                                                          ssm_conv=None)
    _, fresh = m.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                         kv_only, dtype=torch.float32)
    assert fresh.ssm_h.shape == (n_rec, B, 128)


def test_masked_decode_keeps_the_rows_left_out(models):
    """``decode_step(advance=...)`` (the mega-step's masked tick) rewrites
    the recurrent state of the rows that advance and no other, as the
    reference's row merge keeps a failed slot's state for its retry."""
    _, _, m, tp = models
    B = 3
    c = m.make_decode_caches(B, 64, kv_dtype=torch.float32, device="cpu")
    c.ssm_h.normal_()
    c.ssm_conv.normal_()
    h0, conv0 = c.ssm_h.clone(), c.ssm_conv.clone()
    adv = torch.tensor([True, False, True])
    toks = torch.tensor([[5], [6], [7]])
    _, c = m.decode_step(tp, toks, c, dtype=torch.float32, advance=adv)
    assert torch.equal(c.ssm_h[:, 1], h0[:, 1])
    assert torch.equal(c.ssm_conv[:, 1], conv0[:, 1])
    assert not torch.equal(c.ssm_h[:, 0], h0[:, 0])
    assert c.kv.seq_lens.tolist() == [1, 0, 1]
    full = m.make_decode_caches(B, 64, kv_dtype=torch.float32, device="cpu")
    full.ssm_h.copy_(h0)
    full.ssm_conv.copy_(conv0)
    _, full = m.decode_step(tp, toks, full, dtype=torch.float32)
    assert torch.equal(full.ssm_h[:, 0], c.ssm_h[:, 0])
    assert torch.equal(full.ssm_h[:, 2], c.ssm_h[:, 2])


# ---- the serving engine ----------------------------------------------------

def _engines(models, mega, **kw):
    jm, jp, tm, tp = models
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=mega, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


def _drive(engines, trace, max_steps=400):
    """Step both engines through ``trace`` (reference ``TraceItem``s) in
    lockstep, the replay harness's schedule; after every step both hold
    the same KV and aux page ids.  Returns per engine (tokens per uid,
    cancelled uids)."""
    out = [({}, []) for _ in engines]
    items = sorted(trace, key=lambda it: it.step)
    cancel_at, nxt, t = {}, 0, 0
    je, te = engines
    while t < max_steps:
        while nxt < len(items) and items[nxt].step <= t:
            it = items[nxt]
            uids = {e.submit(np.asarray(it.prompt, np.int32),
                             max_new_tokens=it.max_new) for e in engines}
            assert len(uids) == 1
            if it.cancel_step is not None:
                cancel_at.setdefault(max(it.cancel_step, t + 1),
                                     []).append(uids.pop())
            nxt += 1
        for uid in cancel_at.pop(t, []):
            for e, (toks, cancelled) in zip(engines, out):
                if uid not in toks and e.cancel(uid):
                    cancelled.append(uid)
        for e, (toks, _) in zip(engines, out):
            for r in e.step():
                toks[r.uid] = list(map(int, r.out_tokens))
        assert [list(map(int, a)) for a in te.slot_aux] == \
            [[int(p) for p in a] for a in je.slot_aux], f"step {t}"
        assert [list(map(int, a)) for a in te.slot_pages] == \
            [[int(p) for p in a] for a in je.slot_pages], f"step {t}"
        np.testing.assert_array_equal(te.caches.kv.page_table.numpy(),
                                      np.asarray(je.caches.kv.page_table),
                                      err_msg=f"step {t}")
        t += 1
        if nxt == len(items) and all(
                not e.waiting and all(r is None for r in e.slot_req)
                for e in engines):
            return out
    raise AssertionError(f"not drained in {max_steps} steps")


def _check_same(je, te):
    shared = set(je.stats) & set(te.stats)
    assert {"allocs", "frees", "alloc_txns", "aux_pages_per_slot",
            "cancels", "steps", "alloc_failures"} <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    np.testing.assert_array_equal(te.alloc_state.mem.numpy(),
                                  np.asarray(je.alloc_state.mem))
    np.testing.assert_array_equal(te.alloc_state.ctl.numpy(),
                                  np.asarray(je.alloc_state.ctl))


def _drained(te):
    assert te.stats["allocs"] == te.stats["frees"] > 0
    assert all(not a.size for a in te.slot_aux)
    assert bool((te.caches.kv.page_table == -1).all())


# prompts of 70 and 90 tokens pass the smoke config's 64-token window
PROMPT_LENS = (70, 9, 90, 2)


def _plain_trace(cfg, max_new=8):
    rng = np.random.default_rng(len(PROMPT_LENS))
    return [TraceItem(step=0, prompt=tuple(int(t) for t in rng.integers(
        2, cfg.vocab_size, n)), max_new=max_new, cancel_step=None)
        for n in PROMPT_LENS]


def test_engine_matches_reference_host_loop(models):
    """Prompts of 2-90 tokens, 8 new each, max_batch 3: prefill and
    decode past the 64-token window.  (The mega-step runs the abandonment
    trace at max_batch 3 and the requeue at max_batch 2 below, the host
    loop both of them too.)"""
    je, te = _engines(models, False, max_batch=3, max_seq=128)
    assert te.aux_pages == je.aux_pages == 15
    (jt, _), (tt, _) = _drive((je, te), _plain_trace(te.cfg))
    assert tt == jt and len(tt) == len(PROMPT_LENS)
    _check_same(je, te)
    _drained(te)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_abandonment_matches_reference(models, mega):
    """The reference replay harness's abandonment trace (seed 7, as its
    ``test_abandon_parity_with_aux_pages``): cancels of waiting and
    active requests free every page, KV and aux alike."""
    cfg = get_arch(ARCH).smoke()
    trace = generate_trace(SCENARIOS["abandon"], seed=7,
                           vocab_size=cfg.vocab_size, max_seq=96)
    je, te = _engines(models, mega, max_batch=3, max_seq=128)
    (jt, jcan), (tt, tcan) = _drive((je, te), trace)
    assert tcan == jcan and tcan, "the trace cancelled nothing"
    assert tt == jt and tt
    assert te.stats["cancels"] == len(tcan)
    _check_same(je, te)
    _drained(te)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_requeue_when_aux_pages_do_not_fit(models, mega):
    """A co-tenant holds pages so that the heap has room for one slot's
    aux pages and half another's: the second admission fails, runs a
    defrag wave, returns its partial grant and requeues; it is admitted
    when the first request retires, with the reference's tokens."""
    je, te = _engines(models, mega, max_batch=2, max_seq=128)
    aux = te.aux_pages
    free_pages = (te.ouro.frag_stats(te.alloc_state)["free_words"]
                  // te.wpp)
    hold = free_pages - aux - aux // 2 - 8
    sizes = np.full(hold, 256, np.int32)
    je.alloc_state, jo = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                       jnp.ones(hold, bool))
    te.alloc_state, to = te.ouro.alloc(te.alloc_state,
                                       torch.from_numpy(sizes),
                                       torch.ones(hold, dtype=torch.bool))
    assert (to.numpy() >= 0).all()
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    trace = _plain_trace(te.cfg, max_new=6)[1:]
    (jt, _), (tt, _) = _drive((je, te), trace)
    assert tt == jt and len(tt) == 3
    assert te.stats["alloc_failures"] > 0 and te.stats["defrag_waves"] > 0
    te.alloc_state = te.ouro.free(te.alloc_state, to,
                                  torch.from_numpy(sizes), to >= 0)
    je.alloc_state = je.ouro.free(je.alloc_state, jo, jnp.asarray(sizes),
                                  jo >= 0)
    _check_same(je, te)
    _drained(te)


def test_launches_per_tick_counts_the_attention_layers(models, monkeypatch):
    """One grow and one ``paged_attention`` per attention layer a tick,
    in both loops (the port's counters see each dispatch as its kernel's
    wrapper counts a launch on the card): 2 at smoke width (one triple),
    13 at full width (12 triples)."""
    for name in ("paged_attention", "arena_alloc_txn"):
        plain = getattr(ops, name)

        def counted(*a, _plain=plain, _name=name.replace("arena_", ""),
                    **kw):
            ops.count(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    for mega in (True, False):
        e = ServingEngine(models[2], models[3], max_batch=3, max_seq=128,
                          kv_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu",
                          mega_step=mega)
        e.submit(np.arange(2, 40), 4)
        e.step()
        ops.reset_launches()
        assert e.launches_per_tick() == 1 + TF.num_attn_layers(e.cfg) == 2
        assert ops.LAUNCHES["alloc_txn"] == 1
        assert ops.LAUNCHES["paged_attention"] == 1


def test_launch_cli_serves_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch import serve
    for extra in ([], ["--mega"]):
        rc = serve.main(["--arch", ARCH, "--smoke", "--requests", "3",
                         "--max-new", "4", "--max-batch", "2", "--max-seq",
                         "96", "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("REQ ") == 3
        assert "'aux_pages_per_slot': 15" in out
