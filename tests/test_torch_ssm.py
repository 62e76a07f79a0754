"""The port's ssm family (mamba2-780m) held to the JAX reference on the CPU.

Inputs come from numpy with a seed; parameters from the reference
``Model.init`` through ``params_from_jax``.  Tolerances, float32
throughout: the SSD scans 1e-4 (atol and rtol: the same products and
exponentials, summed in another order and, in the reference, through
XLA's cumsum), the model logits atol 1e-4 (as the dense model's
tests), the layer alone, whose unnormalised random inputs drive states
into the thousands, within 2e-5 of its output's largest magnitude.
The engine must give the reference host loop's tokens per uid, its
stats, its ``slot_aux`` page ids after every step and its final arena
words, with ``allocs == frees``: on plain traffic, on the reference
replay harness's abandonment trace (cancels of waiting and active
requests), and on a heap too small for two slots' aux pages, where
admission requeues.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild
from repro.paged import kv_cache as jkv
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.replay import SCENARIOS, TraceItem, generate_trace

from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_plain
from repro_torch.models import params as P
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine

ARCH = "mamba2-780m"
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
ATOL = 1e-4
LAYER_REL = 2e-5


def _close_to_scale(got, want, msg=""):
    """|got - want| <= LAYER_REL * max|want|, elementwise."""
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LAYER_REL * float(np.abs(want).max()), (msg, err)


@pytest.fixture(scope="module")
def ref_model():
    cfg = jget(ARCH).smoke()
    m = jbuild(cfg)
    p = m.init(jax.random.PRNGKey(0))
    return m, p, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def port_model(ref_model):
    cfg = get_arch(ARCH).smoke()
    return build_model(cfg), P.params_from_jax(cfg, ref_model[2])


def test_config_copy_matches_reference():
    for full in (True, False):
        a, b = jget(ARCH), get_arch(ARCH)
        if not full:
            a, b = a.smoke(), b.smoke()
        fa = dataclasses.asdict(a)
        for k, v in dataclasses.asdict(b).items():
            assert fa[k] == v, k
        assert (b.d_inner, b.ssm_nheads, b.padded_vocab) == \
            (a.d_inner, a.ssm_nheads, a.padded_vocab)
    assert get_arch(ARCH).ssm_nheads == 48


@pytest.mark.parametrize("full", (False, True), ids=("smoke", "full"))
def test_modality_page_quota_matches_reference(full):
    a, b = jget(ARCH), get_arch(ARCH)
    if not full:
        a, b = a.smoke(), b.smoke()
    assert KV.modality_page_quota(b) == jkv.modality_page_quota(a)
    if full:
        assert KV.modality_page_quota(b) == 298656
    assert KV.modality_page_quota(get_arch("qwen2-0.5b")) == 0


def _ssd_inputs(seed, B, L, H, P_, G, N, h0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P_)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    b = rng.standard_normal((B, L, G, N)).astype(np.float32)
    c = rng.standard_normal((B, L, G, N)).astype(np.float32)
    h = rng.standard_normal((B, H, P_, N)).astype(np.float32) if h0 else None
    return x, dt, a, b, c, h


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("B,L,H,P_,G,N,chunk,h0", [
    (1, 64, 2, 16, 1, 32, 16, False),
    (2, 48, 4, 16, 2, 32, 16, True),      # two groups, a carried state
    (1, 37, 4, 8, 4, 16, 16, True),       # L not a multiple of the chunk
    (1, 128, 2, 64, 1, 128, 64, False),   # mamba2-780m's head shapes
], ids=("one-group", "groups-h0", "ragged", "full-width-heads"))
def test_ssd_plain_matches_reference(B, L, H, P_, G, N, chunk, h0):
    """``ssd_plain`` against the reference's ``ssd_jnp`` and its naive
    recurrence, the port's ``ssd_ref`` against the reference's, and (L a
    multiple of the chunk) the Pallas kernel in interpret mode."""
    args = _ssd_inputs(B * L + N, B, L, H, P_, G, N, h0)
    x, dt, a, b, c, h = _t(*args)
    y, hf = ssd_plain(x, dt, a, b, c, chunk, h)
    jy, jh = jssm.ssd_jnp(*_j(*args[:5]), chunk, *_j(args[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), **SSD_TOL)
    ry, rh = ref.ssd_ref(x, dt, a, b, c, h)
    jry, jrh = jref.ssd_ref(*_j(*args))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **SSD_TOL)
    np.testing.assert_allclose(rh.numpy(), np.asarray(jrh), **SSD_TOL)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **SSD_TOL)
    np.testing.assert_allclose(hf.numpy(), rh.numpy(), **SSD_TOL)
    if L % chunk == 0:
        ky, kh = jssd_scan(*_j(*args[:5]), h0=_j(args[5])[0], chunk=chunk,
                           interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(ky), **SSD_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(kh), **SSD_TOL)


def test_ssd_plain_chains_states():
    """Two chained scans (the second from the first's final state) equal
    one scan over the whole sequence, and ``ops.ssd_scan`` on CPU tensors
    is the plain version."""
    x, dt, a, b, c, _ = _t(*_ssd_inputs(3, 1, 64, 2, 16, 1, 32))
    y_full, h_full = ops.ssd_scan(x, dt, a, b, c, chunk=16)
    y1, s1 = ssd_plain(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32], 16)
    y2, s2 = ssd_plain(x[:, 32:], dt[:, 32:], a, b[:, 32:], c[:, 32:], 16,
                       s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), h_full.numpy(), atol=1e-4)
    assert ops.LAUNCHES["ssd_scan"] == 0


def test_init_matches_reference_shapes_and_scales(ref_model):
    cfg = get_arch(ARCH).smoke()
    mine = P.init(cfg, 0)
    conv = P.params_from_jax(cfg, ref_model[2])
    assert mine.keys() == conv.keys()
    for bm, bc in zip(mine["blocks"], conv["blocks"]):
        assert bm.keys() == bc.keys() == {"norm", "mixer"}
        for grp in bc:
            assert bm[grp].keys() == bc[grp].keys()
            for nm in bc[grp]:
                assert bm[grp][nm].shape == bc[grp][nm].shape, (grp, nm)
                assert bm[grp][nm].dtype == bc[grp][nm].dtype
    for nm in ("a_log", "dt_bias", "d_skip", "norm_scale", "conv_b"):
        torch.testing.assert_close(mine["blocks"][1]["mixer"][nm],
                                   conv["blocks"][1]["mixer"][nm])
    w = torch.stack([b["mixer"]["in_proj"] for b in mine["blocks"]])
    assert abs(float(w.std()) - cfg.num_layers ** -0.5) < 0.05
    cw = torch.stack([b["mixer"]["conv_w"] for b in mine["blocks"]])
    want = (cfg.num_layers * cfg.ssm_conv) ** -0.5
    assert abs(float(cw.std()) - want) < 0.1 * want


@pytest.mark.parametrize("S", (21, 32))
def test_ssm_layer_prefill_and_decode_match_reference(ref_model, S):
    """``apply_ssm_layer``: a prefill (padded to the chunk when S is not
    a multiple of it), then three decode steps on its states."""
    cfg_j, cfg = jget(ARCH).smoke(), get_arch(ARCH).smoke()
    pj = jax.tree.map(lambda a: a[0], ref_model[1]["blocks"]["mixer"])
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jo, (jh, jc) = jssm.apply_ssm_layer(cfg_j, pj, jnp.asarray(x))
    to, (th, tc) = ssm.apply_ssm_layer(cfg, pt, torch.from_numpy(x))
    _close_to_scale(to, jo, "prefill output")
    _close_to_scale(th, jh, "prefill state")
    _close_to_scale(tc, jc, "prefill conv tail")
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, (jh, jc) = jssm.apply_ssm_layer(cfg_j, pj, jnp.asarray(xt),
                                            (jh, jc))
        to, (th, tc) = ssm.apply_ssm_layer(cfg, pt, torch.from_numpy(xt),
                                           (th, tc))
        _close_to_scale(to, jo, f"decode step {step}")
        _close_to_scale(th, jh, f"decode step {step} state")


def test_prefill_and_decode_logits_match_reference(ref_model, port_model):
    jm, jp, _ = ref_model
    m, tp = port_model
    cfg = m.cfg
    B, S = 2, 21
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jc = jm.make_decode_caches(B, 64)
    tc = m.make_decode_caches(B, 64, kv_dtype=torch.float32, device="cpu")
    assert tc.kv is None and tc.ssm_h.shape == jc.ssm_h.shape
    assert tc.ssm_conv.shape == jc.ssm_conv.shape
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                       dtype=torch.float32)
    assert tl.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _close_to_scale(tc.ssm_h, jc.ssm_h, "prefill states")
    for step in range(3):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, torch.from_numpy(nt).long(), tc,
                               dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    # Caches() in, freshly stacked states out
    _, fresh = m.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                         type(tc)(), dtype=torch.float32)
    assert fresh.ssm_h.shape == tc.ssm_h.shape


# ---- the serving engine -----------------------------------------------------

def _engines(ref_model, port_model, **kw):
    jm, jp, _ = ref_model
    m, tp = port_model
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=False, **kw)
    te = ServingEngine(m, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu", **kw)
    return je, te


def _drive(engines, trace, max_steps=500):
    """Step both engines through ``trace`` (reference ``TraceItem``s:
    arrival step, prompt, budget, cancel step) in lockstep, the replay
    harness's schedule; after every step both hold the same aux page ids
    in every slot.  Returns per engine (tokens per uid, cancelled uids)."""
    out = [({}, []) for _ in engines]
    items = sorted(trace, key=lambda it: it.step)
    cancel_at, nxt, t = {}, 0, 0
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
                toks[r.uid] = list(r.out_tokens)
        je, te = engines
        assert [list(map(int, a)) for a in te.slot_aux] == \
            [[int(p) for p in a] for a in je.slot_aux], f"step {t}"
        t += 1
        if nxt == len(items) and all(
                not e.waiting and all(r is None for r in e.slot_req)
                for e in engines):
            return out
    raise AssertionError(f"not drained in {max_steps} steps")


def _check_same(je, te):
    shared = set(je.stats) & set(te.stats)
    assert {"allocs", "frees", "alloc_txns", "aux_pages_per_slot",
            "cancels", "frag_ratio"} <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    np.testing.assert_array_equal(te.alloc_state.mem.numpy(),
                                  np.asarray(je.alloc_state.mem))
    np.testing.assert_array_equal(te.alloc_state.ctl.numpy(),
                                  np.asarray(je.alloc_state.ctl))
    assert te.stats["allocs"] == te.stats["frees"] > 0
    assert all(not a.size for a in te.slot_aux)
    assert sum(te.stats["shard_pages_live"]) == 0


def _plain_trace(cfg, n, max_batch):
    rng = np.random.default_rng(max_batch)
    prompts = [rng.integers(2, cfg.vocab_size, int(rng.integers(4, 40)))
               for _ in range(n)]
    return [TraceItem(step=0, prompt=tuple(int(t) for t in p),
                      max_new=int(rng.integers(2, 8)), cancel_step=None)
            for p in prompts]


@pytest.mark.parametrize("max_batch", (2, 3))
def test_engine_matches_reference_host_loop(ref_model, port_model,
                                            max_batch):
    je, te = _engines(ref_model, port_model, max_batch=max_batch,
                      max_seq=96)
    assert te.aux_pages == je.aux_pages == 271
    assert te.stats["arena_mem_words"] == je.stats["arena_mem_words"]
    (jt, _), (tt, _) = _drive((je, te), _plain_trace(te.cfg, 5, max_batch))
    assert tt == jt and len(tt) == 5
    _check_same(je, te)
    # one alloc per admission, one free per retirement, nothing else
    assert te.stats["alloc_txns"] == te.stats["free_txns"] == 5
    assert te.caches.kv is None


def test_abandonment_frees_all_pages_host_loop(ref_model, port_model):
    """The reference's ``test_abandonment_frees_all_pages`` (host mode):
    its replay harness's abandonment trace (seed 5) drives both engines;
    cancels of waiting and active requests free every page, KV and aux
    alike, with the reference's tokens, stats and words."""
    cfg = get_arch(ARCH).smoke()
    trace = generate_trace(SCENARIOS["abandon"], seed=5,
                           vocab_size=cfg.vocab_size)
    je, te = _engines(ref_model, port_model, max_batch=3, max_seq=96)
    (jt, jcan), (tt, tcan) = _drive((je, te), trace)
    assert tcan == jcan and tcan, "the trace cancelled nothing"
    assert tt == jt and tt
    assert te.stats["cancels"] == len(tcan)
    _check_same(je, te)


def test_engine_requeues_when_aux_pages_do_not_fit(ref_model, port_model):
    """A co-tenant holds pages so that the heap cannot hold two slots'
    aux pages: the second admission fails, runs a defrag wave, returns
    its partial grant and requeues, and is admitted when the first
    request retires; all as the reference does."""
    je, te = _engines(ref_model, port_model, max_batch=2, max_seq=96)
    aux = te.aux_pages
    free_pages = (te.ouro.frag_stats(te.alloc_state)["free_words"]
                  // te.wpp)
    hold = free_pages - aux - aux // 2     # room for one slot and a half
    sizes = np.full(hold, 256, np.int32)
    je.alloc_state, jo = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                       jnp.ones(hold, bool))
    te.alloc_state, to = te.ouro.alloc(te.alloc_state,
                                       torch.from_numpy(sizes),
                                       torch.ones(hold, dtype=torch.bool))
    assert (to.numpy() >= 0).all()
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    (jt, _), (tt, _) = _drive((je, te), _plain_trace(te.cfg, 3, 2))
    assert tt == jt and len(tt) == 3
    assert te.stats["alloc_failures"] > 0 and te.stats["defrag_waves"] > 0
    # the co-tenant's pages are the only ones still live
    te.alloc_state = te.ouro.free(te.alloc_state, to,
                                  torch.from_numpy(sizes), to >= 0)
    je.alloc_state = je.ouro.free(je.alloc_state, jo, jnp.asarray(sizes),
                                  jo >= 0)
    shared = set(je.stats) & set(te.stats)
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    np.testing.assert_array_equal(te.alloc_state.mem.numpy(),
                                  np.asarray(je.alloc_state.mem))
    assert te.stats["allocs"] == te.stats["frees"]


def test_launch_cli_serves_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCH, "--smoke", "--requests", "3",
                     "--max-new", "4", "--max-batch", "2", "--max-seq", "96",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("REQ ") == 3
    assert "'aux_pages_per_slot': 271" in out
