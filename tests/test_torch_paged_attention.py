"""The port's paged decode attention (plain version of
``csrc/paged_attention.cu``) and paged-KV writes held to the JAX
reference: ``kernels.ref.paged_attention_ref``, the Pallas
``ops.paged_attention`` in interpret mode (page-id and word-offset
tables) and ``kv_cache.paged_attend1`` on float32 caches.  Inputs come
from a numpy seed, with table holes and ragged lengths; atol 1e-5
(float32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.paged import kv_cache as jkv

from repro_torch.kernels import ops, ref
from repro_torch.paged import kv_cache as kv

ATOL = 1e-5
SHAPES = {"qwen2-decode": dict(B=4, Hq=14, Hkv=2, D=64, page=16, P=6,
                               NP=40),
          "smoke": dict(B=3, Hq=4, Hkv=2, D=32, page=16, P=4, NP=20)}


def _inputs(seed, B, Hq, Hkv, D, page, P, NP, empty_row=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((NP, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((NP, page, Hkv, D)).astype(np.float32)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[0, 1] = -1                       # a hole inside the live range
    table[-1, P - 1] = -1
    seq = rng.integers(1, P * page + 1, B).astype(np.int32)
    seq[0] = P * page                      # full table, hole included
    if empty_row and B > 2:
        seq[1] = 0
    return q, k, v, table, seq


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_reference_ref(shape):
    # the dense reference softmax has no defined value on an empty row
    q, k, v, table, seq = _inputs(0, **SHAPES[shape], empty_row=False)
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(seq)))
    got = ref.paged_attention(*_t(q, k, v, table, seq))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("wpp", (None, 64), ids=("page-ids", "word-offsets"))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_pallas_kernel(shape, wpp):
    q, k, v, table, seq = _inputs(1, **SHAPES[shape])
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(seq), wpp=wpp))
    got = ref.paged_attention(*_t(q, k, v, table, seq), wpp=wpp)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert float(got[1].abs().max()) == 0.0     # seq_len 0: output 0


@pytest.mark.parametrize("shape", list(SHAPES))
def test_paged_attend1_matches_reference(shape):
    """The model's decode attention (port) against the reference jnp
    decode attention on float32 caches."""
    q, k, v, table, seq = _inputs(2, **SHAPES[shape], empty_row=False)
    layer = jkv.KVLayer(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=None,
                        v_scale=None)
    want = np.asarray(jkv.paged_attend1(layer, jnp.asarray(table),
                                        jnp.asarray(seq),
                                        jnp.asarray(q)[:, None]))
    qt, kt, vt, tt, st = _t(q, k, v, table, seq)
    got = kv.paged_attend1(kv.KVLayer(kt, vt), tt, st, qt[:, None])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_kv_writes_match_reference():
    """append1 / prefill_write1 in place, with holes and positions past
    the table dropped, give the reference's heaps."""
    rng = np.random.default_rng(3)
    B, S, Hkv, D, page, P, NP = 3, 37, 2, 8, 16, 4, 16
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[1, 1] = -1
    table[2, :] = -1
    kn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    zeros = np.zeros((NP, page, Hkv, D), np.float32)
    jl = jkv.KVLayer(k=jnp.asarray(zeros), v=jnp.asarray(zeros),
                     k_scale=None, v_scale=None)
    jl = jkv.prefill_write1(jl, jnp.asarray(table), jnp.asarray(kn),
                            jnp.asarray(vn))
    tl = kv.KVLayer(torch.zeros(zeros.shape), torch.zeros(zeros.shape))
    kv.prefill_write1(tl, torch.from_numpy(table), *_t(kn, vn))
    np.testing.assert_array_equal(tl.k.numpy(), np.asarray(jl.k))
    np.testing.assert_array_equal(tl.v.numpy(), np.asarray(jl.v))
    seq = np.array([S, 20, 5], np.int32)
    seq_far = np.array([P * page + 3, 20, 5], np.int32)   # past the table
    for sl in (seq, seq_far):
        kt = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        vt = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        jl = jkv.append1(jl, jnp.asarray(table), jnp.asarray(sl),
                         jnp.asarray(kt), jnp.asarray(vt))
        kv.append1(tl, torch.from_numpy(table), torch.from_numpy(sl),
                   *_t(kt, vt))
        np.testing.assert_array_equal(tl.k.numpy(), np.asarray(jl.k))
        np.testing.assert_array_equal(tl.v.numpy(), np.asarray(jl.v))


def test_cpu_dispatch_runs_plain_version_without_launching():
    ops.reset_launches()
    q, k, v, table, seq = _inputs(4, **SHAPES["smoke"])
    args = _t(q, k, v, table, seq)
    got = ops.paged_attention(*args)
    assert torch.equal(got, ref.paged_attention(*args))
    assert ops.LAUNCHES["paged_attention"] == 0


def test_bf16_plain_version_stays_close_to_float32():
    q, k, v, table, seq = _inputs(5, **SHAPES["qwen2-decode"])
    args = _t(q, k, v, table, seq)
    lo = ref.paged_attention(*[a.bfloat16() for a in args[:3]], *args[3:])
    hi = ref.paged_attention(*args)
    assert lo.dtype == torch.float32
    np.testing.assert_allclose(lo.numpy(), hi.numpy(), atol=5e-2, rtol=0)
