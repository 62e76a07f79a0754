"""The port's CUDA kernels held to their plain versions on the card.

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
