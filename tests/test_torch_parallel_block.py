"""The port's last two dense configurations held to the JAX reference on
the CPU: command-r-35b (LayerNorm, a parallel block: attention and FFN
from one norm, summed; embeddings tied to the vocab) and internlm2-20b
(a sequential block, GQA at G 6, untied ``lm_head``).

Inputs come from numpy with a seed; parameters from the reference
``Model.init`` through ``params_from_jax``; both smoke configs are 2
layers, d 128, 4 heads over 2 kv heads of 32, vocab 512.  Every
comparison runs float32.  Tolerances:

- one ``dense_block`` at prefill (S 37, through a shuffled page table)
  and at one decode step after it: outputs and the layer's K/V heaps
  atol ATOL (1e-5; outputs of magnitude about 4);
- the model's logits at prefill (S 45) and three decode steps: atol
  LOGIT_ATOL (1e-4; logits of magnitude about 3, measured up to
  3.4e-5 apart at internlm2's prefill); the K/V heaps, whose
  keys reach about 30 after RoPE, within HEAP_REL (5e-5) of their
  largest magnitude (measured 6.8e-6: the second layer's inputs are the
  first's outputs, in the hundreds at the reference's init);
- the engine: ``launches_per_tick`` and the CLI here; its tokens, page
  ids and stats against the reference in
  ``tests/test_torch_parallel_block_engine.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild
from repro.paged import kv_cache as jkv

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import params as P
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model
from repro_torch.paged import kv_cache as KV
from repro_torch.serve.engine import ServingEngine

ARCHS = ("command-r-35b", "internlm2-20b")
ATOL = 1e-5
LOGIT_ATOL = 1e-4
HEAP_REL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def models(arch):
    """(reference model, its params, port model, converted params)."""
    if arch not in _MODELS:
        cfg, tcfg = jget(arch).smoke(), get_arch(arch).smoke()
        jm = jbuild(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[arch] = (jm, jp, build_model(tcfg), P.params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp)))
    return _MODELS[arch]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _keys(tree):
    """The tree's key paths (lists of blocks by their first entry)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(tree[0])] if tree else []
    return None


# ---- configs and parameters -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    for a, b in ((jget(arch), get_arch(arch)),
                 (jget(arch).smoke(), get_arch(arch).smoke())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        P.check_supported(b)
    full = get_arch(arch)
    want = {"command-r-35b": (40, 8192, 64, 8, 128, 22528, 256000,
                              "layernorm", True, True, 8e6),
            "internlm2-20b": (48, 6144, 48, 8, 128, 16384, 92672,
                              "rmsnorm", False, False, 1e6)}[arch]
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim_, full.d_ff, full.padded_vocab,
            full.norm, full.parallel_block, full.tie_embeddings,
            full.rope_theta) == want
    assert KV.modality_page_quota(full) == 0 == jkv.modality_page_quota(
        jget(arch))


def test_check_supported_takes_every_reference_config():
    """All ten reference configs; ``logit_softcap`` is still refused."""
    from repro.configs import ALL_ARCHS
    assert len(ALL_ARCHS) == 10
    for arch in ALL_ARCHS:
        P.check_supported(get_arch(arch))
        P.check_supported(get_arch(arch).smoke())
    with pytest.raises(NotImplementedError, match="logit_softcap"):
        P.check_supported(dataclasses.replace(get_arch("command-r-35b"),
                                              logit_softcap=30.0))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_matches_reference(arch):
    """The converted tree has the reference's keys (no ``norm2`` in a
    parallel block, no ``lm_head`` with tied embeddings) and values;
    ``init`` builds the same keys and shapes."""
    jm, jp, m, tp = models(arch)
    cfg = m.cfg
    jblocks = {g: set(v) for g, v in jp["blocks"].items()}
    for blk in tp["blocks"]:
        assert {g: set(v) for g, v in blk.items()} == jblocks
    assert ("norm2" in jblocks) == (not cfg.parallel_block)
    assert set(tp) == set(jp) == ({"embed", "final_norm", "blocks"} | (
        set() if cfg.tie_embeddings else {"lm_head"}))
    for i, blk in enumerate(tp["blocks"]):
        for g, leaves in blk.items():
            for nm, t in leaves.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jp["blocks"][g][nm][i]))
    mine = P.init(cfg, 0)
    assert _keys(mine) == _keys(tp)
    for bm, bc in zip(mine["blocks"], tp["blocks"]):
        for g in bc:
            for nm in bc[g]:
                assert bm[g][nm].shape == bc[g][nm].shape, (g, nm)
    if cfg.norm == "layernorm":
        assert not mine["blocks"][0]["norm1"]["bias"].any()


# ---- the block ----------------------------------------------------------------

def _block_params(cfg, rng):
    """One block's leaves from numpy, the matrices at std 1/sqrt(fan-in)
    (the reference's init, std 1/sqrt(num_layers), drives the block's
    outputs into the hundreds, where float32 rounds at 6e-5), norm
    scales near 1 and biases near 0, so outputs are of magnitude about
    4."""
    out = {}
    for g, leaves in P._block_shapes(cfg).items():
        out[g] = {}
        for nm, shp in leaves.items():
            noise = rng.standard_normal(shp).astype(np.float32)
            out[g][nm] = (1 + 0.1 * noise if nm == "scale" else
                          0.1 * noise if nm == "bias" else
                          noise / np.float32(np.sqrt(shp[0])))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_reference(arch):
    """One block at prefill (S 37 through a shuffled page table), then
    one decode step: outputs and the layer's heaps."""
    jm, _, m, _ = models(arch)
    cfg = m.cfg
    B, S, max_seq = 2, 37, 64
    rng = np.random.default_rng(3)
    blk = _block_params(cfg, rng)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    table = rng.permutation(B * 4).astype(np.int32).reshape(B, 4)
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    tc = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                              device="cpu")
    jkvl = jkv.KVLayer(*(None if t is None else t[0] for t in jc.kv.layers))
    tkvl = tc.kv.layer(0)
    jblk = jax.tree.map(jnp.asarray, blk)
    tblk = {g: {nm: _t(v) for nm, v in leaves.items()}
            for g, leaves in blk.items()}
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    zero = np.zeros(B, np.int32)
    want, jkvl, _ = jtf.dense_block(cfg, jblk, jnp.asarray(x),
                                    jnp.asarray(pos), "prefill", jkvl,
                                    jnp.asarray(table), jnp.asarray(zero))
    got = TF.dense_block(cfg, tblk, _t(x), _t(pos).long(), "prefill", tkvl,
                         _t(table), _t(zero))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for g, w in ((tkvl.k, jkvl.k), (tkvl.v, jkvl.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    lens = np.full(B, S, np.int32)
    want, jkvl, _ = jtf.dense_block(cfg, jblk, jnp.asarray(x1),
                                    jnp.asarray(lens[:, None]), "decode",
                                    jkvl, jnp.asarray(table),
                                    jnp.asarray(lens))
    got = TF.dense_block(cfg, tblk, _t(x1), _t(lens[:, None]).long(),
                         "decode", tkvl, _t(table), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for g, w in ((tkvl.k, jkvl.k), (tkvl.v, jkvl.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_is_the_sum_or_the_sequence(arch):
    """Train mode, bit for bit: a parallel block is ``x + a + f`` with
    both branches on ``norm1(x)``; a sequential block is the parent's
    ``x + a``, then ``+ f`` of ``norm2``."""
    _, _, m, tp = models(arch)
    cfg, p = m.cfg, tp["blocks"][0]
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9)
    got = TF.dense_block(cfg, p, x, pos, "train", None, None, None)
    h = layers.apply_norm(cfg, p["norm1"], x)
    a = TF._attn_mix(cfg, p["attn"], h, pos, "train", None, None, None,
                     None)
    if cfg.parallel_block:
        want = x + a + layers.apply_mlp(cfg, p["ffn"], h)
    else:
        x2 = x + a
        want = x2 + layers.apply_mlp(
            cfg, p["ffn"], layers.apply_norm(cfg, p["norm2"], x2))
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """A 45-token prefill through shuffled page tables, then three
    decode steps: logits and K/V heaps."""
    jm, jp, m, tp = models(arch)
    cfg = m.cfg
    B, S, max_seq = 2, 45, 64
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = rng.permutation(B * 4).astype(np.int32).reshape(B, 4)
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    jc = jc._replace(kv=jc.kv._replace(page_table=jnp.asarray(table)))
    tc = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                              device="cpu")
    tc.kv.page_table.copy_(_t(table))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": _t(toks).long()}, tc,
                       dtype=torch.float32)
    assert tl.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    for step in range(3):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, _t(nt).long(), tc, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    for got, want in ((tc.kv.layers.k, jc.kv.layers.k),
                      (tc.kv.layers.v, jc.kv.layers.v)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= HEAP_REL * float(np.abs(want).max()), err


@pytest.mark.parametrize("arch", ARCHS)
def test_launches_per_tick_counts_the_layers(arch, monkeypatch):
    """One grow and one ``paged_attention`` a layer a tick, in both
    loops: 3 at smoke width (41 and 49 at full depth)."""
    for name in ("paged_attention", "arena_alloc_txn"):
        plain = getattr(ops, name)

        def counted(*a, _plain=plain, _name=name.replace("arena_", ""),
                    **kw):
            ops.count(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, _, tm, tp = models(arch)
    for mega in (True, False):
        e = ServingEngine(tm, tp, max_batch=3, max_seq=96,
                          kv_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu",
                          mega_step=mega)
        e.submit(np.arange(2, 40), 4)
        e.step()
        ops.reset_launches()
        assert e.launches_per_tick() == 1 + e.cfg.num_layers == 3
        assert ops.LAUNCHES["paged_attention"] == 2
    assert 1 + get_arch(arch).num_layers == {"command-r-35b": 41,
                                             "internlm2-20b": 49}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_cli_serves_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    for extra in ([], ["--mega"]):
        rc = serve.main(["--arch", arch, "--smoke", "--requests", "3",
                         "--max-new", "4", "--max-batch", "2", "--max-seq",
                         "96", "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("REQ ") == 3
        assert "'allocs': " in out and "alloc_failures': 0" in out
