"""The port's model, engine and entry points held to the JAX reference.

Parameters come from the reference ``Model.init`` through
``params_from_jax``; prefill/decode logits must be allclose (atol 1e-4,
float32: the same sums in another order).  The port's
``ServingEngine(device="cpu")`` must give the reference host loop's
tokens per uid, shared stats and final arena words.  A guard walks the
port's sources for JAX/reference imports, and the entry points must
refuse to run on the CPU unless asked to.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.models import layers, params as P
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref_model():
    cfg = jget("qwen2-0.5b").smoke()
    m = jbuild(cfg)
    p = m.init(jax.random.PRNGKey(0))
    return m, p, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def port_model(ref_model):
    cfg = get_arch("qwen2-0.5b").smoke()
    return build_model(cfg), P.params_from_jax(cfg, ref_model[2])


def test_config_copy_matches_reference():
    for full in (True, False):
        a = jget("qwen2-0.5b")
        b = get_arch("qwen2-0.5b")
        if not full:
            a, b = a.smoke(), b.smoke()
        fa = dataclasses.asdict(a)
        for k, v in dataclasses.asdict(b).items():
            assert fa[k] == v, k
        assert (b.head_dim_, b.padded_vocab) == (a.head_dim_, a.padded_vocab)
    assert get_arch("qwen2-0.5b").padded_vocab == 152064


def test_init_matches_reference_shapes_and_scales(ref_model):
    """Same tree, shapes and distributions as the reference init
    (std 1/sqrt(num_layers) for block matrices, 1/sqrt(V_pad) for the
    embedding, ones and zeros for norms and biases)."""
    cfg = get_arch("qwen2-0.5b").smoke()
    mine = P.init(cfg, 0)
    conv = P.params_from_jax(cfg, ref_model[2])
    assert mine.keys() == conv.keys()
    assert mine["embed"].shape == conv["embed"].shape
    for bm, bc in zip(mine["blocks"], conv["blocks"]):
        for grp in bc:
            for nm in bc[grp]:
                assert bm[grp][nm].shape == bc[grp][nm].shape, (grp, nm)
                assert bm[grp][nm].dtype == bc[grp][nm].dtype
    wq = torch.stack([b["attn"]["wq"] for b in mine["blocks"]])
    assert abs(float(wq.std()) - cfg.num_layers ** -0.5) < 0.05
    assert abs(float(mine["embed"].std()) - cfg.padded_vocab ** -0.5) \
        < 0.1 * cfg.padded_vocab ** -0.5
    assert float(mine["blocks"][0]["norm1"]["scale"].min()) == 1.0
    assert float(mine["blocks"][0]["attn"]["bq"].abs().max()) == 0.0


def test_layers_match_reference():
    cfg_j = jget("qwen2-0.5b").smoke()
    cfg = get_arch("qwen2-0.5b").smoke()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32) * 3
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_norm(cfg, {"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.apply_norm(cfg_j, {"scale": jnp.asarray(scale)},
                                      jnp.asarray(x))), atol=1e-5)
    h = rng.standard_normal((2, 9, 4, cfg.head_dim_)).astype(np.float32)
    pos = np.tile(np.arange(9), (2, 1)) + np.array([[0], [40]])
    np.testing.assert_allclose(
        layers.apply_rope(cfg, torch.from_numpy(h),
                          torch.from_numpy(pos)).numpy(),
        np.asarray(jlayers.apply_rope(cfg_j, jnp.asarray(h),
                                      jnp.asarray(pos))), atol=1e-5)
    q = rng.standard_normal((2, 13, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 32)).astype(np.float32)
    for blk in (512, 4):                    # one block, and many
        np.testing.assert_allclose(
            layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   block=blk).numpy(),
            np.asarray(jlayers.flash_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                block=blk)), atol=1e-5)


def test_prefill_and_decode_logits_match_reference(ref_model, port_model):
    jm, jp, _ = ref_model
    m, tp = port_model
    cfg = m.cfg
    B, S, max_seq = 2, 21, 64
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = np.arange(B * 4, dtype=np.int32).reshape(B, 4)
    table[1] = table[1][::-1]               # pages out of order
    jc = jm.make_decode_caches(B, max_seq, kv_dtype=jnp.float32)
    jc = jc._replace(kv=jc.kv._replace(page_table=jnp.asarray(table)))
    tc = m.make_decode_caches(B, max_seq, kv_dtype=torch.float32,
                              device="cpu")
    tc.kv.page_table.copy_(torch.from_numpy(table))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                        remat_policy="none", dtype=jnp.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                       dtype=torch.float32)
    assert tl.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for step in range(3):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nt), jc, dtype=jnp.float32)
        tl, tc = m.decode_step(tp, torch.from_numpy(nt).long(), tc,
                               dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(tc.kv.seq_lens.numpy(),
                                  np.asarray(jc.kv.seq_lens))


def _requests(cfg, seed, n, max_seq):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, cfg.vocab_size,
                          int(rng.integers(4, max_seq // 4))),
             int(rng.integers(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("max_batch", (2, 3))
def test_engine_matches_reference_host_loop(ref_model, port_model,
                                            max_batch):
    jm, jp, _ = ref_model
    m, tp = port_model
    reqs = _requests(m.cfg, max_batch, 5, 96)
    je = JEngine(jm, jp, max_batch=max_batch, max_seq=96,
                 kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=False)
    te = ServingEngine(m, tp, max_batch=max_batch, max_seq=96,
                       kv_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu")
    for p, n in reqs:
        je.submit(p, n)
        te.submit(p, n)
    want = {r.uid: r.out_tokens for r in je.run_until_done()}
    got = {r.uid: r.out_tokens for r in te.run_until_done()}
    assert got == want
    shared = set(je.stats) & set(te.stats)
    assert {"allocs", "frees", "steps", "alloc_txns", "free_words",
            "frag_ratio"} <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    np.testing.assert_array_equal(te.alloc_state.mem.numpy(),
                                  np.asarray(je.alloc_state.mem))
    np.testing.assert_array_equal(te.alloc_state.ctl.numpy(),
                                  np.asarray(je.alloc_state.ctl))
    assert te.stats["allocs"] == te.stats["frees"]
    assert bool((te.caches.kv.page_table == -1).all())


def test_engine_allocation_failure_names_roadmap_item(port_model):
    m, tp = port_model
    te = ServingEngine(m, tp, max_batch=2, max_seq=96, num_pages=2,
                       kv_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu")
    big = te.ouro.cfg.total_words // te.wpp
    te.submit(np.arange(2, 2 + 16 * big, dtype=np.int32) % 500 + 2, 4)
    with pytest.raises(RuntimeError, match="A10"):
        te.run_until_done()
    assert te.stats["allocs"] == te.stats["frees"]


def test_launch_cli_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--requests", "3",
                     "--max-new", "4", "--max-batch", "2", "--max-seq", "96",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("REQ ") == 3
    assert "served 3 requests" in out


def test_entry_points_default_to_cuda_and_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    from repro_torch.core import HeapConfig, Ouroboros
    from repro_torch.launch import serve
    from repro_torch.paged.kv_cache import make_kv_allocator
    cfg = get_arch("qwen2-0.5b").smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        Ouroboros(HeapConfig(total_bytes=1 << 16, chunk_bytes=1 << 11),
                  "vl_chunk")
    with pytest.raises(RuntimeError, match="cuda"):
        make_kv_allocator(64)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(build_model(cfg), P.init(cfg, 0))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--requests", "1"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke exits non-zero and prints no result line when there is
    no CUDA device, and when it stands alone without the package."""
    import subprocess
    import sys
    import shutil
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)],
                           capture_output=True, text=True, timeout=120,
                           cwd=script.parent)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
