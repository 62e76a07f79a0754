"""The port's encoder-decoder family (seamless-m4t-large-v2: LayerNorm,
GeGLU, a bidirectional encoder, cross-attention with a per-row valid
length) held to the JAX reference on the CPU.

Inputs come from numpy with a seed; parameters from the reference
``Model.init`` through ``params_from_jax``; the smoke config is 2
encoder and 2 decoder layers, d 128, 4 heads over 2 kv heads of 32.
Every comparison runs float32.  Tolerances:

- LayerNorm: atol 1e-5 at unit inputs (outputs of magnitude about 4);
- ``flash_attention`` with ``kv_valid_len``: atol 1e-5 (outputs below
  4); a row of valid length 0 is exactly 0 in both packages;
- ``encode`` and the train-mode ``decode_stack``: atol LOGIT_ATOL
  (5e-4) on outputs of magnitude about 4 (measured 6.4e-5 and 9.9e-5);
- ``prefill`` and three ``decode_step``s: logits and the cross K/V atol
  LOGIT_ATOL, the paged K/V heaps within HEAP_REL (5e-4) of their
  largest magnitude (about 30 after RoPE; measured 8.5e-4 apart, 3e-5
  of it); and the port's
  paged decode against its own train-mode forward within 1% of the
  logits' largest magnitude, as the reference's ``test_system`` holds
  its own;
- the engine, host loop and mega-step: the reference's tokens per uid,
  KV page ids after every step, stats and arena words, with ``allocs ==
  frees``; each active row's cross K/V within LOGIT_ATOL of the
  reference's (which encodes the whole padded batch and keeps the row;
  the port encodes the row alone) and its valid length equal, on plain
  traffic, through the reference replay harness's abandonment trace
  (cancels) and through a requeue at admission.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro.models.model import kv_dtype_for as jkv_dtype_for
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.replay import SCENARIOS, generate_trace

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import encdec as ED
from repro_torch.models import layers
from repro_torch.models import params as P
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model, kv_dtype_for
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine
from torch_lockstep import (check_same, drained, drive, hold_all_but,
                            plain_trace)

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-5
LOGIT_ATOL = 5e-4
HEAP_REL = 5e-4
SELF_REL = 1e-2


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


# ---- configs and parameters -----------------------------------------------

def test_config_copy_matches_reference():
    for full in (True, False):
        a, b = jget(ARCH), get_arch(ARCH)
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.is_encdec and b.is_encdec
    full = get_arch(ARCH)
    assert (full.family, full.num_layers, full.enc_layers, full.d_model,
            full.num_heads, full.num_kv_heads, full.head_dim_, full.d_ff,
            full.norm, full.act, full.rope_theta, full.tie_embeddings,
            full.modality) == ("encdec", 24, 24, 1024, 16, 16, 64, 8192,
                               "layernorm", "gelu", 1e4, False, "audio")
    assert full.padded_vocab == 256256
    sm = full.smoke()
    assert (sm.num_layers, sm.enc_layers, sm.num_kv_heads) == (2, 2, 2)
    assert not get_arch("qwen2-0.5b").is_encdec
    assert TF.num_attn_layers(full) == 24 and TF.num_rec_layers(full) == 0
    assert KV.modality_page_quota(full) == 0


def test_check_supported_accepts_encdec_and_refuses_the_rest():
    for cfg in (get_arch(ARCH), get_arch(ARCH).smoke()):
        P.check_supported(cfg)
    # command-r's parallel block is supported now, in the dense family;
    # an encoder-decoder with one is still refused
    P.check_supported(jget("command-r-35b"))
    with pytest.raises(NotImplementedError, match="parallel_block"):
        P.check_supported(dataclasses.replace(get_arch(ARCH),
                                              parallel_block=True))
    # an encoder only with the encdec family, and the reverse
    for bad in (dataclasses.replace(get_arch(ARCH), enc_layers=0),
                dataclasses.replace(get_arch("qwen2-0.5b"), enc_layers=2)):
        with pytest.raises(NotImplementedError, match="enc_layers"):
            P.check_supported(bad)


def test_kv_dtype_for_counts_the_decoder_layers_twice():
    """Self and cross K/V, as the reference's rule counts them: 48
    layers x 16 kv heads x 64 x 2 x 2 bytes a token, 3.3e12 bytes at 512
    x 32,768 tokens, pass 2.5e12; 24 layers (1.6e12) would not."""
    cfg = get_arch(ARCH)
    for batch, want in ((512, torch.int8), (256, torch.bfloat16),
                        (8, torch.bfloat16)):
        assert kv_dtype_for(cfg, 32768, batch) == want
        assert jnp.dtype(jkv_dtype_for(jget(ARCH), 32768, batch)).name == \
            str(want)[6:]
    half = dataclasses.replace(cfg, enc_layers=0, family="dense")
    assert kv_dtype_for(half, 32768, 512) == torch.bfloat16


def test_params_from_jax_unstacks_encoder_and_decoder(models):
    jm, jp, m, tp = models
    assert tp.keys() == {"embed", "enc_in", "enc_blocks", "enc_norm",
                         "dec_blocks", "final_norm", "lm_head"}
    assert len(tp["enc_blocks"]) == 2 and len(tp["dec_blocks"]) == 2
    assert tp["dec_blocks"][0].keys() == {"norm1", "attn", "norm_x",
                                          "xattn", "norm2", "ffn"}
    for name in ("enc_blocks", "dec_blocks"):
        for i, blk in enumerate(tp[name]):
            for grp, leaves in jp[name].items():
                for nm, arr in leaves.items():
                    np.testing.assert_array_equal(blk[grp][nm].numpy(),
                                                  np.asarray(arr)[i])
    for name in ("enc_norm", "final_norm"):
        assert tp[name].keys() == {"scale", "bias"}
    np.testing.assert_array_equal(tp["enc_in"].numpy(),
                                  np.asarray(jp["enc_in"]))


def test_init_matches_reference_shapes_biases_and_scales(models):
    """Same tree, shapes and dtypes as the converted reference; every
    LayerNorm's bias is zeros and its scale ones (the trap: a leaf of a
    ``norm*`` group used to come out as ones whatever its name); normal
    leaves have std 1/sqrt(enc_layers) in the encoder and
    1/sqrt(num_layers) in the decoder, ``enc_in`` and ``lm_head``
    1/sqrt(d)."""
    cfg = get_arch(ARCH).smoke()
    mine, conv = P.init(cfg, 0), models[3]

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
        if any(str(g).startswith("norm") or str(g).endswith("_norm")
               for g in k[:-1]):
            want = 0.0 if k[-1] == "bias" else 1.0
            assert bool((a[k] == want).all()), k
            assert bool((b[k] == want).all()), k
    big = dataclasses.replace(get_arch(ARCH), num_layers=16, enc_layers=4,
                              d_model=256, d_ff=512, num_heads=4,
                              num_kv_heads=4, head_dim=64, vocab_size=512)
    w = P.init(big, 0)
    for name, n in (("enc_blocks", 4), ("dec_blocks", 16)):
        for grp, nm in (("attn", "wq"), ("ffn", "w_up")):
            x = torch.stack([b_[grp][nm] for b_ in w[name]])
            assert abs(float(x.std()) - n ** -0.5) < 0.05 * n ** -0.5, name
    for nm in ("enc_in", "lm_head"):
        assert abs(float(w[nm].std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    xw = torch.stack([b_["xattn"]["wk"] for b_ in w["dec_blocks"]])
    assert abs(float(xw.std()) - 16 ** -0.5) < 0.05 * 16 ** -0.5
    half = P.init(cfg, 0, dtype=torch.bfloat16)
    cast = P.cast_for_compute(half, torch.float32)
    assert cast["enc_in"].dtype == torch.float32
    assert cast["dec_blocks"][0]["norm_x"]["bias"].dtype == torch.bfloat16


# ---- layers ----------------------------------------------------------------

def test_layernorm_matches_reference():
    cfg, jcfg = get_arch(ARCH).smoke(), jget(ARCH).smoke()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32) + 0.5
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = np.asarray(jlayers.apply_norm(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = layers.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # zero mean and unit variance before the affine part
    unit = layers.apply_norm(cfg, {"scale": torch.ones(cfg.d_model),
                                   "bias": torch.zeros(cfg.d_model)}, _t(x))
    assert float(unit.mean(-1).abs().max()) < 1e-5
    # the RMSNorm branch is untouched
    rms = dataclasses.replace(cfg, norm="rmsnorm")
    want = np.asarray(jlayers.apply_norm(
        dataclasses.replace(jcfg, norm="rmsnorm"),
        {"scale": jnp.asarray(p["scale"])}, jnp.asarray(x)))
    got = layers.apply_norm(rms, {"scale": _t(p["scale"])}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hkv,block", [(2, 512), (4, 8), (1, 16)])
def test_flash_attention_kv_valid_len_matches_reference(hkv, block):
    """Bidirectional attention of 5 queries over 40 keys with valid
    lengths 0, 1, 17 and 40 (blocks of ``block`` keys: the masked keys
    straddle blocks, and a row's first blocks may be all masked); G 1,
    2 and 4.  A row of valid length 0 is zeros, not NaN."""
    rng = np.random.default_rng(hkv * 100 + block)
    B, S, T, Hq, D = 4, 5, 40, 4, 32
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    valid = np.array([0, 1, 17, 40], np.int32)
    want = np.asarray(jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_valid_len=jnp.asarray(valid), block=block))
    got = layers.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                 kv_valid_len=_t(valid), block=block)
    assert bool(torch.isfinite(got).all())
    assert bool((got[0] == 0).all()) and bool((want[0] == 0).all())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # a row of valid length 1 sees only key 0: its output is v[0]
    G = Hq // hkv
    np.testing.assert_allclose(
        got[1].numpy(), np.repeat(v[1, 0], G, axis=0)[None].repeat(S, 0),
        atol=ATOL)
    # the full row equals the unmasked attention
    free = layers.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                  block=block)
    np.testing.assert_allclose(got[3].numpy(), free[3].numpy(), atol=ATOL)


# ---- the model -------------------------------------------------------------

def test_encode_matches_reference(models):
    jm, jp, m, tp = models
    rng = np.random.default_rng(2)
    se = rng.standard_normal((2, 40, m.cfg.d_model)).astype(np.float32)
    want = np.asarray(jed.encode(jm.cfg, jp, jnp.asarray(se), "none",
                                 jnp.float32))
    got = ED.encode(m.cfg, tp, _t(se), torch.float32)
    assert got.shape == (2, 40, m.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_decode_stack_train_mode_matches_reference(models):
    jm, jp, m, tp = models
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 40, m.cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, m.cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jed.decode_stack(jm.cfg, jp, jnp.asarray(toks),
                               jnp.asarray(enc), "train",
                               jed.EncDecCaches(None, None, None, None),
                               "none", jnp.float32)
    got, c = ED.decode_stack(m.cfg, tp, _t(toks).long(), _t(enc), "train",
                             ED.EncDecCaches(), torch.float32)
    assert got.shape == (2, 24, m.cfg.padded_vocab)
    assert c.cross_k is None and c.self_kv is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def _prefill_pair(models, B=2, S=24, Se=48, max_seq=64, seed=4):
    """Both packages prefilled on the same tokens, frames and valid
    lengths through the same shuffled page tables."""
    jm, jp, m, tp = models
    cfg = m.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    se = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    valid = np.array([Se - 11, 9][:B], np.int32)
    pps = max_seq // KV.PAGE_SIZE
    table = rng.permutation(B * pps).astype(np.int32).reshape(B, pps)
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    jc = jc._replace(self_kv=jc.self_kv._replace(
        page_table=jnp.asarray(table)))
    # cross K/V for Se frames, the table of max_seq tokens
    tc = m.make_decode_caches(B, Se, kv_dtype=torch.float32, device="cpu",
                              num_pages=B * pps)
    tc = tc._replace(self_kv=tc.self_kv._replace(page_table=_t(table)))
    assert tc.cross_k.shape == (cfg.num_layers, B, Se, cfg.num_kv_heads,
                                cfg.head_dim_)
    assert tc.cross_k.dtype == torch.float32
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "src_embeds": jnp.asarray(se),
                             "src_valid": jnp.asarray(valid)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": _t(toks).long(), "src_embeds": _t(se),
                            "src_valid": _t(valid)}, tc, dtype=torch.float32)
    return rng, (jl, jc), (tl, tc), (toks, se, valid)


def test_prefill_and_decode_logits_match_reference(models):
    """A 24-token prefill over 48 frames (valid lengths 37 and 9), then
    three decode steps: logits, the cross K/V written in place, the
    valid lengths and the paged self K/V heaps."""
    jm, jp, m, tp = models
    rng, (jl, jc), (tl, tc), _ = _prefill_pair(models)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for got, want in ((tc.cross_k, jc.cross_k), (tc.cross_v, jc.cross_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL)
    assert tc.enc_valid.tolist() == np.asarray(jc.enc_valid).tolist()
    assert tc.self_kv.seq_lens.tolist() == [24, 24]
    cross = tc.cross_k.clone()
    for step in range(3):
        nt = rng.integers(0, m.cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, _t(nt).long(), tc, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
    assert torch.equal(tc.cross_k, cross)          # decode only reads it
    assert tc.self_kv.seq_lens.tolist() == [27, 27]
    for got, want in ((tc.self_kv.layers.k, jc.self_kv.layers.k),
                      (tc.self_kv.layers.v, jc.self_kv.layers.v)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= HEAP_REL * float(np.abs(want).max()), err


def test_paged_decode_matches_train_forward(models):
    """The port's prefill of 16 tokens then decode token by token equal
    its own train-mode pass over all 24 (frames unmasked), within 1% of
    the logits' largest magnitude, as the reference's ``test_system``
    holds its own; and the train-mode pass equals the reference's."""
    jm, jp, m, tp = models
    cfg, B, T, S0 = m.cfg, 2, 24, 16
    rng = np.random.default_rng(5)
    toks = _t(rng.integers(0, cfg.vocab_size, (B, T))).long()
    se = _t(rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32))
    enc = ED.encode(cfg, tp, se, torch.float32)
    full, _ = ED.decode_stack(cfg, tp, toks, enc, "train", ED.EncDecCaches(),
                              torch.float32)
    c = m.make_decode_caches(B, T, kv_dtype=torch.float32, device="cpu")
    pps = c.self_kv.page_table.shape[1]
    c.self_kv.page_table.copy_(torch.arange(B * pps, dtype=torch.int32)
                               .reshape(B, pps))
    # no cross K/V in the caches and no src_valid: both come back made
    c = c._replace(cross_k=None, cross_v=None)
    lp, c = m.prefill(tp, {"tokens": toks[:, :S0], "src_embeds": se}, c,
                      dtype=torch.float32)
    assert c.cross_k.shape == (cfg.num_layers, B, 20, cfg.num_kv_heads,
                               cfg.head_dim_)
    assert c.enc_valid is None
    scale = float(full.abs().max())
    errs = [float((lp - full[:, S0 - 1]).abs().max())]
    for t in range(S0, T):
        ld, c = m.decode_step(tp, toks[:, t:t + 1], c, dtype=torch.float32)
        errs.append(float((ld - full[:, t]).abs().max()))
    assert max(errs) < SELF_REL * max(scale, 1.0), errs
    want, _ = jed.decode_stack(jm.cfg, jp, jnp.asarray(toks.numpy()),
                               jnp.asarray(enc.numpy()), "train",
                               jed.EncDecCaches(None, None, None, None),
                               "none", jnp.float32)
    np.testing.assert_allclose(full.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


def test_masked_decode_advances_only_the_rows_given(models):
    """``decode_step(advance=...)`` (the mega-step's masked tick) moves
    only those rows' ``seq_lens`` and leaves the cross K/V alone."""
    _, _, m, tp = models
    rng, _, (_, tc), _ = _prefill_pair(models, seed=6)
    k0 = tc.cross_k.clone()
    adv = torch.tensor([False, True])
    _, tc = m.decode_step(tp, torch.tensor([[5], [6]]), tc,
                          dtype=torch.float32, advance=adv)
    assert tc.self_kv.seq_lens.tolist() == [24, 25]
    assert torch.equal(tc.cross_k, k0)


# ---- the serving engine ----------------------------------------------------

def _engines(models, mega, **kw):
    jm, jp, tm, tp = models
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=mega, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


def _same_rows(je, te, t):
    """Every active row's cross K/V within LOGIT_ATOL of the
    reference's, and its valid encoder length equal."""
    for s, r in enumerate(te.slot_req):
        if r is None:
            continue
        assert int(te.caches.enc_valid[s]) == int(je.caches.enc_valid[s])
        for got, want in ((te.caches.cross_k, je.caches.cross_k),
                          (te.caches.cross_v, je.caches.cross_v)):
            np.testing.assert_allclose(got[:, s].numpy(),
                                       np.asarray(want)[:, s],
                                       atol=LOGIT_ATOL,
                                       err_msg=f"step {t} slot {s}")


PROMPT_LENS = (40, 9, 70, 2)


@pytest.mark.parametrize("max_batch", (2, 3))
@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_engine_matches_reference(models, mega, max_batch):
    """Prompts of 2-70 tokens, 8 new each: the encoder's 96 frames with
    the prompt length valid, the row's cross K/V written at admission
    (the port encodes the row alone), decode through paged
    self-attention."""
    je, te = _engines(models, mega, max_batch=max_batch, max_seq=96)
    assert te.caches.cross_k.shape[2] == 96
    (jt, _), (tt, _) = drive((je, te), plain_trace(te.cfg, PROMPT_LENS),
                             _same_rows)
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
    (jt, jcan), (tt, tcan) = drive((je, te), trace, _same_rows)
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
    first request retires, with the reference's tokens and cross
    rows."""
    je, te = _engines(models, mega, max_batch=2, max_seq=96)
    release = hold_all_but(je, te, 5)
    trace = plain_trace(te.cfg, (40, 33, 9), max_new=6)
    (jt, _), (tt, _) = drive((je, te), trace, _same_rows)
    assert tt == jt and len(tt) == 3
    assert te.stats["alloc_failures"] > 0 and te.stats["defrag_waves"] > 0
    release()
    check_same(je, te)
    drained(te)


def test_launches_per_tick_counts_the_decoder_layers(models, monkeypatch):
    """One grow and one ``paged_attention`` per decoder layer a tick, in
    both loops (the encoder and the cross-attention launch no kernel): 3
    at smoke width, 25 at full width."""
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
        valid = e.caches.enc_valid.clone()
        ops.reset_launches()
        assert e.launches_per_tick() == 1 + e.cfg.num_layers == 3
        assert ops.LAUNCHES["paged_attention"] == 2
        assert torch.equal(e.caches.enc_valid, valid)


def test_launch_cli_serves_seamless_on_cpu(capsys):
    from repro_torch.launch import serve
    for extra in ([], ["--mega"]):
        rc = serve.main(["--arch", ARCH, "--smoke", "--requests", "3",
                         "--max-new", "4", "--max-batch", "2", "--max-seq",
                         "96", "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("REQ ") == 3
        assert "'allocs': 5, 'frees': 5" in out
