"""The port's VLM family (qwen2-vl-2b: M-RoPE over three position
streams, ``mm_embeds`` added to the token embeddings, QKV bias, tied
embeddings) held to the JAX reference on the CPU.

Inputs come from numpy with a seed; parameters from the reference
``Model.init`` through ``params_from_jax``; the smoke config is 2
layers, d 128, 4 heads over 2 kv heads of 32, M-RoPE sections (4, 6,
6).  Every comparison runs float32.  Tolerances:

- ``apply_rope``: atol 1e-5 (rotations of unit inputs at positions up
  to 500);
- ``forward`` (train mode) with ``mm_embeds`` and distinct t/h/w
  positions, ``prefill`` with both and three ``decode_step``s: logits
  atol LOGIT_ATOL (5e-4; logits of magnitude about 4), the K/V heaps
  within HEAP_REL (5e-4) of their largest magnitude;
- the engine, host loop and mega-step: the reference's tokens per uid,
  KV page ids after every step, stats and arena words, with ``allocs ==
  frees``, on plain traffic, through the reference replay harness's
  abandonment trace (cancels) and through a requeue at admission.  The
  reference engine passes neither ``mm_embeds`` nor positions, so the
  three streams are equal there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.replay import SCENARIOS, generate_trace

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import params as P
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine
from torch_lockstep import (check_same, drained, drive, hold_all_but,
                            plain_trace)

ARCH = "qwen2-vl-2b"
ATOL = 1e-5
LOGIT_ATOL = 5e-4
HEAP_REL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg, tcfg = jget(ARCH).smoke(), get_arch(ARCH).smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _streams(rng, B, S):
    """Three distinct position streams (t, h, w), batch-first (B, 3, S),
    as a VLM batch carries them: t grows, h and w walk a patch grid."""
    t = np.arange(S)[None].repeat(B, 0) + rng.integers(0, 5, (B, 1))
    h = (np.arange(S) // 4)[None].repeat(B, 0) + rng.integers(0, 50, (B, 1))
    w = (np.arange(S) % 4)[None].repeat(B, 0) * 7
    return np.stack([t, h, w], 1).astype(np.int32)


# ---- configs ---------------------------------------------------------------

def test_config_copy_matches_reference():
    for full in (True, False):
        a, b = jget(ARCH), get_arch(ARCH)
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert not b.is_encdec
    full = get_arch(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim_, full.d_ff, full.qkv_bias,
            full.tie_embeddings, full.mrope_sections,
            full.modality) == ("dense", 28, 1536, 12, 2, 128, 8960, True,
                               True, (16, 24, 24), "vision")
    assert sum(full.mrope_sections) == full.head_dim_ // 2
    sm = full.smoke()
    assert sm.mrope_sections == (4, 6, 6)
    assert sum(sm.mrope_sections) == sm.head_dim_ // 2
    assert KV.modality_page_quota(full) == 0
    for cfg in (full, sm):
        P.check_supported(cfg)


# ---- M-RoPE ----------------------------------------------------------------

@pytest.mark.parametrize("full", (False, True), ids=("smoke", "full"))
def test_mrope_matches_reference(full):
    """Distinct t/h/w streams (3, B, S) at the smoke and full sections;
    2-D positions broadcast to all three streams, which is plain RoPE;
    distinct streams differ from it exactly in the h and w sections."""
    cfg, jcfg = get_arch(ARCH), jget(ARCH)
    if not full:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    D = cfg.head_dim_
    rng = np.random.default_rng(D)
    B, S, H = 2, 9, 3
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 500, (3, B, S)).astype(np.int32)
    want = np.asarray(jlayers.apply_rope(jcfg, jnp.asarray(x),
                                         jnp.asarray(pos)))
    got = layers.apply_rope(cfg, _t(x), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    flat = pos[0]
    want2 = np.asarray(jlayers.apply_rope(jcfg, jnp.asarray(x),
                                          jnp.asarray(flat)))
    got2 = layers.apply_rope(cfg, _t(x), _t(flat).long())
    np.testing.assert_allclose(got2.numpy(), want2, atol=ATOL, rtol=0)
    plain = layers.apply_rope(dataclasses.replace(cfg, mrope_sections=None),
                              _t(x), _t(flat).long())
    np.testing.assert_allclose(got2.numpy(), plain.numpy(), atol=ATOL)
    # the temporal section rotates by stream 0 alone
    t_sec = cfg.mrope_sections[0]
    half = D // 2
    for lo, hi in ((0, t_sec), (half, half + t_sec)):
        np.testing.assert_allclose(got[..., lo:hi].numpy(),
                                   got2[..., lo:hi].numpy(), atol=ATOL)
    assert float((got - got2)[..., t_sec:half].abs().max()) > 0.1


# ---- the model -------------------------------------------------------------

def test_forward_with_mm_embeds_and_positions_matches_reference(models):
    """Train-mode logits with ``mm_embeds`` added and batch-first (B, 3,
    S) positions; without either they differ."""
    jm, jp, m, tp = models
    cfg = m.cfg
    rng = np.random.default_rng(7)
    B, S = 2, 20
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mm = 0.5 * rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = _streams(rng, B, S)
    want, _, _ = jtf.forward(jm.cfg, jp, jnp.asarray(toks),
                             positions=jnp.asarray(pos),
                             extra_embeds=jnp.asarray(mm), mode="train",
                             remat_policy="none", dtype=jnp.float32)
    got, _ = TF.forward(cfg, tp, _t(toks).long(), positions=_t(pos).long(),
                        extra_embeds=_t(mm), mode="train",
                        dtype=torch.float32)
    assert got.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    bare, _ = TF.forward(cfg, tp, _t(toks).long(), mode="train",
                         dtype=torch.float32)
    assert float((bare - got).abs().max()) > 0.1
    # mm_embeds is added in the compute dtype, after the gather
    x = TF.embed(cfg, tp, _t(toks).long(), _t(mm), dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, tp["embed"].bfloat16()[_t(toks).long()]
                       + _t(mm).bfloat16())


def test_prefill_and_decode_logits_match_reference(models):
    """A 30-token prefill with ``mm_embeds`` and three position streams
    through shuffled page tables, then three decode steps (one stream
    at ``seq_lens``, broadcast): logits and K/V heaps."""
    jm, jp, m, tp = models
    cfg = m.cfg
    B, S, max_seq = 2, 30, 64
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mm = 0.5 * rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = _streams(rng, B, S)
    table = rng.permutation(B * 4).astype(np.int32).reshape(B, 4)
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    jc = jc._replace(kv=jc.kv._replace(page_table=jnp.asarray(table)))
    tc = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                              device="cpu")
    tc.kv.page_table.copy_(_t(table))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "mm_embeds": jnp.asarray(mm),
                             "positions": jnp.asarray(pos)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": _t(toks).long(), "mm_embeds": _t(mm),
                            "positions": _t(pos).long()}, tc,
                       dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert tc.kv.seq_lens.tolist() == [S, S]
    for step in range(3):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, _t(nt).long(), tc, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
    for got, want in ((tc.kv.layers.k, jc.kv.layers.k),
                      (tc.kv.layers.v, jc.kv.layers.v)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= HEAP_REL * float(np.abs(want).max()), err


# ---- the serving engine ----------------------------------------------------

def _engines(models, mega, **kw):
    jm, jp, tm, tp = models
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=mega, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


PROMPT_LENS = (40, 9, 70, 2)


@pytest.mark.parametrize("max_batch", (2, 3))
@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_engine_matches_reference(models, mega, max_batch):
    """Prompts of 2-70 tokens, 8 new each."""
    je, te = _engines(models, mega, max_batch=max_batch, max_seq=96)
    (jt, _), (tt, _) = drive((je, te), plain_trace(te.cfg, PROMPT_LENS))
    assert tt == jt and len(tt) == len(PROMPT_LENS)
    check_same(je, te)
    drained(te)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_abandonment_matches_reference(models, mega):
    """The reference replay harness's abandonment trace (seed 7):
    cancels of waiting and active requests free every page."""
    cfg = get_arch(ARCH).smoke()
    trace = generate_trace(SCENARIOS["abandon"], seed=7,
                           vocab_size=cfg.vocab_size, max_seq=96)
    je, te = _engines(models, mega, max_batch=3, max_seq=128)
    (jt, jcan), (tt, tcan) = drive((je, te), trace)
    assert tcan == jcan and tcan, "the trace cancelled nothing"
    assert tt == jt and tt
    assert te.stats["cancels"] == len(tcan)
    check_same(je, te)
    drained(te)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_requeue_when_pages_do_not_fit(models, mega):
    """A co-tenant leaves the heap room for the first prompt's pages and
    not the second's: the second admission fails, runs a defrag wave,
    returns its partial grant and requeues; it is admitted when the
    first request retires, with the reference's tokens."""
    je, te = _engines(models, mega, max_batch=2, max_seq=96)
    release = hold_all_but(je, te, 5)
    (jt, _), (tt, _) = drive((je, te), plain_trace(te.cfg, (40, 33, 9),
                                                    max_new=6))
    assert tt == jt and len(tt) == 3
    assert te.stats["alloc_failures"] > 0 and te.stats["defrag_waves"] > 0
    release()
    check_same(je, te)
    drained(te)


def test_launches_per_tick_counts_the_layers(models, monkeypatch):
    """One grow and one ``paged_attention`` a layer a tick, in both
    loops: 3 at smoke width, 29 at full width."""
    for name in ("paged_attention", "arena_alloc_txn"):
        plain = getattr(ops, name)

        def counted(*a, _plain=plain, _name=name.replace("arena_", ""),
                    **kw):
            ops.count(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    for mega in (True, False):
        e = ServingEngine(models[2], models[3], max_batch=3, max_seq=96,
                          kv_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu",
                          mega_step=mega)
        e.submit(np.arange(2, 40), 4)
        e.step()
        ops.reset_launches()
        assert e.launches_per_tick() == 1 + e.cfg.num_layers == 3
        assert ops.LAUNCHES["paged_attention"] == 2


def test_launch_cli_serves_qwen2_vl_on_cpu(capsys):
    from repro_torch.launch import serve
    for extra in ([], ["--mega"]):
        rc = serve.main(["--arch", ARCH, "--smoke", "--requests", "3",
                         "--max-new", "4", "--max-batch", "2", "--max-seq",
                         "96", "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("REQ ") == 3
        assert "'allocs': 5, 'frees': 5" in out
