"""The port's CUDA kernel sources, compiled for the host and held to their
plain PyTorch versions on the CPU: paged attention (plain, split, window
and ring, int8), the ``ssd_scan`` kernels and the piecewise steps
(``ring_txn_pop``, ``ring_txn_push``, ``ring_window``,
``chunk_txn_claim``, ``bitmap_select``).

``tests/cuda_emu`` emulates the device features the kernels use (a
std::thread per CUDA thread, block and warp barriers, host atomics), so
the kernel bodies of ``src/repro_torch/csrc/*.cu`` run here unchanged,
minus their host launchers; ``cuda_emu/emu.py`` builds that harness once
a module (the ``emu`` fixture).  This checks the kernels' logic on every
run; the card itself checks compilation for sm_90a and real concurrency
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Skips when no C++20
host compiler is available.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import alloc_txn as AT
from repro_torch.paged.kv_cache import _quant

from cuda_emu.emu import emu  # noqa: F401  (the harness fixture)
from cuda_emu.emu import CSRC, EMU, _device_part, _p, _stats


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_kernel_matches_plain(emu, dtype, wpp):
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D, page, P, NP = 4, 14, 2, 64, 16, 6, 40
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[0, 2] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    seq = np.array([P * page, 0, 37, 1], np.int32)
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    tt, st = torch.from_numpy(table), torch.from_numpy(seq)
    want = ref.paged_attention(q, k, v, tt, st, wpp=wpp)
    got = torch.empty((B, Hq, D), dtype=torch.float32)
    emu.emu_paged_attention(int(dtype == torch.bfloat16), 1, _p(q), _p(k),
                            _p(v), _p(tt), _p(st), _p(got), B, Hq, Hkv, D,
                            page, P, NP, int(wpp or 0), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


# (B, Hq, Hkv, D, page, P, NP, seq_lens, holes as (row, first page, last
# page + 1)); splits of 64 tokens: 4 pages of 16, 8 of 8
SPLIT_CASES = {
    # 4 splits (the last of one page); lengths 0, 1, a split's exact
    # multiple, P * page, ragged; a hole inside a live split, a split
    # of holes, holes past the live range
    "qwen2-heads": (6, 14, 2, 64, 16, 13, 90,
                    [0, 1, 64, 13 * 16, 100, 37],
                    [(4, 2, 3), (3, 4, 8), (5, 5, 13), (2, 1, 2)]),
    # rows of 24 bytes in bf16 (not 16-byte chunks): element copies
    "narrow-rows": (3, 4, 1, 12, 8, 11, 40, [88, 9, 0],
                    [(0, 3, 4), (1, 2, 11)]),
    # a table of no pages: one split a sequence, every output 0
    "no-pages": (2, 4, 2, 16, 16, 0, 4, [0, 5], []),
}


@pytest.mark.parametrize("case", tuple(SPLIT_CASES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_split_kernel_matches_plain(emu, case, dtype, wpp):
    """The split kernels and the fold over pages: pages split across
    blocks (a split past the sequence exits, a split of holes adds
    nothing), ragged lengths, holes inside and past the live range, both
    table modes and dtypes, 16-byte and element copies: atol 1e-5 of the
    plain version on the same (widened) values."""
    B, Hq, Hkv, D, page, P, NP, seq, holes = SPLIT_CASES[case]
    rng = np.random.default_rng(P)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    tt = torch.from_numpy(table)
    st = torch.tensor(seq, dtype=torch.int32)
    want = ref.paged_attention(q, k, v, tt, st, wpp=wpp)
    vec = (D * k.element_size()) % 16 == 0
    assert vec == (case != "narrow-rows" or dtype == torch.float32)
    got = torch.full((B, Hq, D), float("nan"), dtype=torch.float32)
    emu.emu_paged_attention(int(dtype == torch.bfloat16), int(vec), _p(q),
                            _p(k), _p(v), _p(tt), _p(st), _p(got), B, Hq,
                            Hkv, D, page, P, NP, int(wpp or 0),
                            1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert not bool(got[(st == 0) | (P == 0)].any())   # no token: 0


# (B, Hq, Hkv, D, page, P, NP, seq_lens, window, ring, holes): windows
# and ring tables at mixtral's head shape (G 4, D 128) and at narrow rows
WINDOW_CASES = {
    # a 96-token window: its first token on a split boundary (160, 224),
    # one past it (161), inside a page (100), longer than the sequence
    # (64); a hole inside the window, holes only before it
    "mixtral-heads-window": (6, 8, 2, 128, 16, 16, 200,
                             [0, 64, 100, 160, 161, 224], 96, False,
                             [(3, 0, 4), (4, 7, 8), (5, 2, 9)]),
    # ring tables of 10 slots (window // page + 2, as mixtral's 258):
    # sequences that do not wrap (16, 159), that end on a lap's last
    # token (160), start the next lap (161) and wrap several times (1000,
    # 4097), with holes
    "mixtral-heads-ring": (6, 8, 2, 128, 16, 10, 120,
                           [16, 159, 160, 161, 1000, 4097], 128,
                           True, [(3, 4, 5), (5, 0, 2)]),
    # a ring without a window: every slot of the last lap is attended
    "ring-no-window": (4, 8, 2, 64, 16, 6, 40, [0, 70, 96, 333], None, True,
                       [(3, 1, 2)]),
    # rows of 24 bytes in bf16 (element copies), pages of 8, a window of
    # 20 tokens inside a ring of 5 slots
    "narrow-ring-window": (3, 4, 1, 12, 8, 5, 30, [7, 41, 200], 20, True,
                           [(2, 3, 4)]),
    # recurrentgemma-9b's heads: G 16 on one kv head of 256 (the merge
    # block's 1024 threads fold 4 outputs each; the scores kernel's
    # shared memory passes 48 KB), ragged lengths, a 96-token window and
    # holes inside and before it, then a ring of 10 slots that wraps
    "hybrid-heads-window": (4, 16, 1, 256, 16, 12, 50, [0, 100, 161, 190],
                            96, False, [(2, 3, 5), (3, 0, 4)]),
    "hybrid-heads-ring": (4, 16, 1, 256, 16, 10, 60, [16, 160, 161, 1000],
                          128, True, [(3, 4, 5), (1, 9, 10)]),
}


@pytest.mark.parametrize("case", tuple(WINDOW_CASES))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("wpp", (None, 64))
def test_paged_attention_window_ring_kernel_matches_plain(emu, case, dtype,
                                                          wpp):
    """``window`` and ``ring`` in the split kernels and the fold: windows
    whose edges fall on split boundaries and inside pages, ring tables
    shorter than the sequence that wrap, holes, both table modes and
    dtypes, D = 128 at G = 4 and D = 256 at G = 16: atol 1e-5 of the
    plain version on the same (widened) values.  Slots before the window
    or off the ring's last lap are loaded by no split."""
    B, Hq, Hkv, D, page, P, NP, seq, window, ring, holes = \
        WINDOW_CASES[case]
    rng = np.random.default_rng(NP)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    tt = torch.from_numpy(table)
    st = torch.tensor(seq, dtype=torch.int32)
    want = ref.paged_attention(q, k, v, tt, st, wpp=wpp, window=window,
                               ring=ring)
    vec = (D * k.element_size()) % 16 == 0
    got = torch.full((B, Hq, D), float("nan"), dtype=torch.float32)
    emu.emu_paged_attention_window(
        int(dtype == torch.bfloat16), int(vec), _p(q), _p(k), _p(v), _p(tt),
        _p(st), _p(got), B, Hq, Hkv, D, page, P, NP, int(wpp or 0),
        int(window or 0), int(ring), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert not bool(got[st == 0].any())   # no token: 0
    # the window and the ring change what is attended in these cases
    plain = ref.paged_attention(q, k, v, tt, st, wpp=wpp)
    assert float((plain - want).abs().max()) > 1e-3


# (B, Hq, Hkv, D, page, P, NP, seq_lens, window, ring, wpp, holes): int8
# pages with per-(slot, head) scales at G = 1 (qwen1.5-32b's heads, D
# 128), 4 and 7, D 32-128, both table modes, a window, a wrapping ring,
# and rows of 24 int8 elements (element copies)
INT8_CASES = {
    "g1-d128": (3, 2, 2, 128, 16, 5, 24, [0, 37, 80], None, False, None,
                [(2, 1, 2)]),
    "g4-d64-offsets": (4, 8, 2, 64, 16, 6, 40, [96, 1, 50, 70], None, False,
                       64, [(0, 2, 3), (3, 4, 6)]),
    "g7-d32": (3, 14, 2, 32, 16, 5, 30, [80, 17, 64], None, False, None,
               [(1, 0, 1)]),
    "g4-d128-window": (4, 8, 2, 128, 16, 12, 60, [20, 100, 161, 190], 96,
                       False, 64, [(2, 3, 5), (3, 0, 4)]),
    "g1-d128-ring": (4, 2, 2, 128, 16, 10, 50, [16, 160, 161, 1000], 128,
                     True, None, [(3, 4, 5)]),
    "narrow-rows": (2, 2, 1, 24, 8, 5, 20, [33, 7], None, False, 64,
                    [(0, 3, 4)]),
}


def _int8_inputs(case, q_dtype):
    """Unit-normal q in ``q_dtype`` and K, V quantized as the KV cache
    stores them (``kv_cache._quant``: int8 words, a float32 scale per
    (page, slot, kv head)), a permuted table with holes."""
    B, Hq, Hkv, D, page, P, NP, seq, window, ring, wpp, holes = \
        INT8_CASES[case]
    rng = np.random.default_rng(NP + D)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k8, ks = _quant(torch.from_numpy(
        rng.standard_normal((NP, page, Hkv, D), np.float32)))
    v8, vs = _quant(torch.from_numpy(
        rng.standard_normal((NP, page, Hkv, D), np.float32)))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    return (q.to(q_dtype).contiguous(), k8, v8, ks, vs,
            torch.from_numpy(table), torch.tensor(seq, dtype=torch.int32),
            dict(wpp=wpp, window=window, ring=ring))


def _emu_int8(so, q, k8, v8, ks, vs, tt, st, wpp, window, ring):
    B, Hq, D = q.shape
    NP, page, Hkv, _ = k8.shape
    got = torch.full((B, Hq, D), float("nan"), dtype=torch.float32)
    so.emu_paged_attention_int8(
        int(q.dtype == torch.bfloat16), int(D % 16 == 0), _p(q), _p(k8),
        _p(v8), _p(ks), _p(vs), _p(tt), _p(st), _p(got), B, Hq, Hkv, D, page,
        tt.shape[1], NP, int(wpp or 0), int(window or 0), int(ring),
        1.0 / D ** 0.5)
    return got


@pytest.mark.parametrize("case", tuple(INT8_CASES))
@pytest.mark.parametrize("q_dtype", (torch.float32, torch.bfloat16))
def test_paged_attention_int8_kernel_matches_plain(emu, case, q_dtype):
    """int8 pages in the split kernels and the fold: each element read
    as float(k8) * scale of its (page, slot, kv head), q in float32 and
    bf16, G 1, 4 and 7, D 24-128 (16-byte chunks of 16 int8 elements,
    or element copies), both table modes, a window and a wrapping ring,
    holes and ragged lengths: atol 1e-5 of the plain version on the same
    values."""
    q, k8, v8, ks, vs, tt, st, kw = _int8_inputs(case, q_dtype)
    want = ref.paged_attention(q, k8, v8, tt, st, k_scale=ks, v_scale=vs,
                               **kw)
    got = _emu_int8(emu, q, k8, v8, ks, vs, tt, st, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert not bool(got[st == 0].any())   # no token: 0
    # the scales matter: the words alone give another result
    ones = torch.ones_like(ks)
    words = ref.paged_attention(q, k8, v8, tt, st, k_scale=ones,
                                v_scale=ones, **kw)
    assert float((words - want).abs().max()) > 1e-3


# one-line mutations of the kernel source's scale read: the slot or the
# kv head of a token's scale off by one
SCALE_MUTATIONS = {
    "wrong-slot": ("(id * page + u % page) * Hkv + h]",
                   "(id * page + (u + 1) % page) * Hkv + h]"),
    "wrong-head": ("(id * page + u % page) * Hkv + h]",
                   "(id * page + u % page) * Hkv + (h + 1) % Hkv]"),
}


@pytest.mark.parametrize("mutation", tuple(SCALE_MUTATIONS))
def test_paged_attention_int8_scale_mutation_fails(mutation,
                                                   tmp_path_factory):
    """The int8 cases catch a scale read from the wrong slot or head: the
    attention kernels alone (``cuda_emu/attention_harness.cpp``) built
    from a mutated copy of the source give an error far past the
    tolerance on two of the cases above."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / "paged_attention.cu").read_text()
    old, new = SCALE_MUTATIONS[mutation]
    assert src.count(old) == 1, "the scale read moved: update the mutation"
    out = tmp_path_factory.mktemp("cuda_emu_mutant")
    (out / "attention_emu.inc").write_text(
        _device_part(src.replace(old, new)))
    lib = out / "libattention.so"
    r = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{EMU / 'include'}", f"-I{EMU}",
                        f"-I{out}", "-o", str(lib),
                        str(EMU / "attention_harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "c++20" in r.stderr.lower():
        pytest.skip(f"host compiler lacks C++20: {r.stderr[:200]}")
    assert r.returncode == 0, r.stderr
    so = ctypes.CDLL(str(lib))
    so.emu_paged_attention_int8.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float]
    so.emu_paged_attention_int8.restype = None
    for case in ("g4-d64-offsets", "g1-d128-ring"):
        q, k8, v8, ks, vs, tt, st, kw = _int8_inputs(case, torch.float32)
        want = ref.paged_attention(q, k8, v8, tt, st, k_scale=ks,
                                   v_scale=vs, **kw)
        got = _emu_int8(so, q, k8, v8, ks, vs, tt, st, **kw)
        assert float((got - want).abs().max()) > 1e-3, case


def _ssd_inputs(rng, B, L, H, P, G, N, dtype, with_h0):
    """Mamba-2-like inputs: softplus steps around the reference's init
    (dt_bias -3), a = -exp(log 4), unit-variance x, B and C."""
    x = torch.from_numpy(rng.standard_normal((B, L, H, P), np.float32))
    raw = rng.standard_normal((B, L, H)).astype(np.float32) - 3.0
    dt = torch.nn.functional.softplus(torch.from_numpy(raw))
    a = -torch.exp(torch.from_numpy(
        (np.log(4.0) + 0.3 * rng.standard_normal(H)).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal((B, L, G, N), np.float32))
    c = torch.from_numpy(rng.standard_normal((B, L, G, N), np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((B, H, P, N), np.float32))
          if with_h0 else None)
    x, b, c = (t.to(dtype).contiguous() for t in (x, b, c))
    return x, dt, a, b, c, h0


H100_SMS = 132


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("B,L,H,P,G,N,Q,with_h0,sms", [
    (1, 128, 2, 64, 1, 128, 64, True, H100_SMS),  # mamba2-780m's heads
    # the same on a card of one SM: each head's state in one block
    (1, 128, 2, 64, 1, 128, 64, True, 1),
    (2, 48, 4, 16, 2, 32, 16, False, H100_SMS),  # the smoke config, G 2
    (1, 24, 3, 8, 3, 16, 8, True, H100_SMS),     # G == H, tiles half empty
    (1, 16, 4, 16, 1, 32, 16, False, H100_SMS),  # one chunk, zero state
    (2, 16, 4, 16, 2, 32, 16, True, H100_SMS),   # one chunk from h0
    (1, 32, 4, 16, 2, 32, 16, True, H100_SMS),   # two chunks, G 2, h0
    (2, 48, 2, 24, 1, 40, 16, True, H100_SMS),   # three chunks, N past a tile
    (1, 60, 4, 12, 2, 20, 20, False, H100_SMS),  # Q and N off the 16 tiles
    (1, 24, 2, 6, 1, 10, 12, True, H100_SMS),    # P, N off the 4-wide stores
], ids=("full-width-heads", "full-width-heads-whole-blocks", "smoke-groups",
        "small", "one-chunk", "one-chunk-h0", "two-chunks-h0",
        "three-chunks-ragged-n", "ragged-q", "ragged-p"))
def test_ssd_scan_kernel_matches_plain(emu, dtype, B, L, H, P, G, N, Q,
                                       with_h0, sms):
    """The emulated ``ssd_scan`` against ``ssd_plain`` on the same
    values (bf16 inputs are widened to float32 by both): atol and rtol
    1e-4, the same float32 products summed in another order."""
    from repro_torch.kernels.ssd_scan import ssd_plain
    rng = np.random.default_rng(B * 100 + L)
    x, dt, a, b, c, h0 = _ssd_inputs(rng, B, L, H, P, G, N, dtype, with_h0)
    want_y, want_h = ssd_plain(x, dt, a, b, c, Q, h0)
    y = torch.empty((B, L, H, P), dtype=torch.float32)
    hf = torch.empty((B, H, P, N), dtype=torch.float32)
    emu.emu_ssd_scan(int(dtype == torch.bfloat16), _p(x), _p(dt), _p(a),
                     _p(b), _p(c), None if h0 is None else _p(h0), _p(y),
                     _p(hf), B, L, H, P, G, N, Q, sms)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hf.numpy(), want_h.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---- the piecewise allocator's steps (csrc/ring_txn.cu, bitmap_txn.cu) -----

def _bool(a):
    return torch.from_numpy(np.asarray(a, dtype=bool))


def _i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


# (lanes, classes, ring capacity, counter base, the one class of every
# lane or None for random ones): counters past 2^31 (wrapped negative),
# and just below it (ranks carry them across), for ring rows of every
# size the allocator uses, on each path the launchers pick: one warp for
# 32 lanes or fewer (the chunk drain's 1-lane pops of a class ring and of
# the pool, C = 1), one block ranking every class above that (33 lanes,
# and 1100, 4096, 6000 and init's one-class push of 684 chunks x 16
# pages, 10,944 lanes, for its batches of 2, 4, 8 and 16 groups a warp
# in one pass; 20,000 lanes in two), one block per class past 32
# classes.  Random lanes mix classes, masked lanes and the
# classes -1 and C within a tile of 32.
RING_CASES = [(16, 3, 48, 0, None), (4096, 5, 1024, -2 ** 31 + 7, None),
              (4096, 5, 1000, 2 ** 31 - 300, None),
              (1, 5, 48, -2 ** 31 + 7, 4), (1, 1, 64, 2 ** 31 - 2, 0),
              (32, 32, 40, 2 ** 31 - 50, None), (33, 5, 48, -2 ** 31 + 3,
                                                 None),
              (33, 32, 40, 0, None), (40, 33, 40, 2 ** 31 - 60, None),
              (1100, 3, 512, -2 ** 31 + 100, None),
              (6000, 5, 2000, 2 ** 31 - 1000, None),
              (10944, 5, 10944, 2 ** 31 - 5000, 0),
              (20000, 5, 5000, -2 ** 31 + 11, None)]
RING_IDS = ("16-lanes", "4096-lanes-wrapped", "4096-lanes-crossing",
            "1-lane-wrapped", "1-lane-pool-crossing", "32-lanes-32-classes",
            "33-lanes-wrapped", "33-lanes-32-classes",
            "40-lanes-33-classes-crossing", "1100-lanes-wrapped",
            "6000-lanes-crossing", "10944-lanes-one-class",
            "20000-lanes-wrapped")


def _ring_path(n, C):
    """The kernel path the launchers pick (csrc/ring_txn.cu, ring_path)."""
    return "class" if C > 32 else "warp" if n <= 32 else "block"


def _ring_inputs(n, C, cap, base, seed, one=None):
    rng = np.random.default_rng(seed)
    store = _i32(rng.integers(0, 10 ** 6, (C, cap)))
    front = base + rng.integers(0, 3 * cap, C)
    if one is None:
        back = front + rng.integers(0, cap + 1, C)
        # lanes of the classes -1 and C lie outside [0, C)
        cls = _i32(rng.integers(-1, C + 1, n))
        valid = _bool(rng.random(n) < 0.8)
    else:
        back = front + rng.integers(1, cap + 1, C)
        cls = _i32(np.full(n, one))
        valid = _bool(np.ones(n, bool))
    return store, _i32(front), _i32(back), cls, valid


def _ring_ran(emu, n, C, kind):
    """The ring launches since the last read, which must be one of
    ``kind`` ("pop" or "push") on the path the launchers pick."""
    ran = {k: v for k, v in _stats(emu.emu_ring_launch_stats,
                                   AT.RING_LAUNCH_STATS).items() if v}
    assert ran == {f"ring_txn_{kind}_{_ring_path(n, C)}": 1}, ran


@pytest.mark.parametrize("limit", (True, False), ids=("limit", "pool"))
@pytest.mark.parametrize("n,C,cap,base,one", RING_CASES, ids=RING_IDS)
def test_ring_txn_pop_kernel_matches_plain(emu, n, C, cap, base, one,
                                           limit):
    """The emulated ``ring_txn_pop`` on the path its launcher picks (one
    warp, one block ranking every class by ``rank_lanes``, or one block
    per class), as its own launch count says, gives the plain version's
    values and fronts: masked lanes and lanes of an out-of-range class
    read −1, ``limit`` grants the inventory's rank prefix."""
    store, front, back, cls, valid = _ring_inputs(n, C, cap, base, n + C,
                                                  one)
    want_v, want_f = ref.ring_txn_pop_ref(store, front, back, cls, valid,
                                          limit)
    vals = torch.full((n,), 12345, dtype=torch.int32)
    nf = torch.empty(C, dtype=torch.int32)
    _stats(emu.emu_ring_launch_stats, AT.RING_LAUNCH_STATS)
    emu.emu_ring_txn_pop(_p(store), _p(front), _p(back), _p(cls), _p(valid),
                         n, C, cap, int(limit), _p(vals), _p(nf))
    _ring_ran(emu, n, C, "pop")
    assert torch.equal(vals, want_v) and torch.equal(nf, want_f)
    assert int((want_v >= 0).sum()) > 0
    if one is None:
        assert int((want_v < 0).sum()) > 0


@pytest.mark.parametrize("n,C,cap,base,one", RING_CASES, ids=RING_IDS)
def test_ring_txn_push_kernel_matches_plain(emu, n, C, cap, base, one):
    """The emulated ``ring_txn_push`` on the path its launcher picks
    writes the plain version's store in place (only its members' slots)
    and its backs."""
    store, _, back, cls, valid = _ring_inputs(n, C, cap, base, 2 * n + C,
                                              one)
    counts = torch.bincount(cls[valid & (cls >= 0) & (cls < C)].long(),
                            minlength=C)
    assert int(counts.max()) <= cap
    vals = _i32(np.random.default_rng(n).integers(0, 10 ** 6, n))
    want_s, want_b = ref.ring_txn_push_ref(store.clone(), back, cls, vals,
                                           valid)
    got_s = store.clone()
    nb = torch.empty(C, dtype=torch.int32)
    _stats(emu.emu_ring_launch_stats, AT.RING_LAUNCH_STATS)
    emu.emu_ring_txn_push(_p(got_s), _p(back), _p(cls), _p(vals), _p(valid),
                          n, C, cap, _p(nb))
    _ring_ran(emu, n, C, "push")
    assert torch.equal(got_s, want_s) and torch.equal(nb, want_b)
    assert not torch.equal(got_s, store)


@pytest.mark.parametrize("C,cap,m,base", [
    (5, 256, 100, -2 ** 31 + 3), (3, 1024, 1024, 2 ** 31 - 600),
    (1, 32, 8, 30)], ids=("wrapped", "full-ring-crossing", "small"))
def test_ring_window_kernel_matches_plain(emu, C, cap, m, base):
    """The emulated ``ring_window`` (a grid of tiles x classes) gives
    the plain window, wrapped rows and empty classes included."""
    rng = np.random.default_rng(cap)
    store = _i32(rng.integers(0, 10 ** 6, (C, cap)))
    front = _i32(base + rng.integers(0, 2 * cap, C))
    counts = _i32(rng.integers(0, m + 1, C))
    counts[0] = 0
    want = ref.ring_window_ref(store, front, counts, m)
    got = torch.empty((C, m), dtype=torch.int32)
    emu.emu_ring_window(_p(store), _p(front), _p(counts), C, cap, m,
                        _p(got))
    assert torch.equal(got, want)


@pytest.mark.parametrize("bw,ppc", [(1, 16), (1, 32), (4, 128),
                                    (1100, 1100 * 32 - 5)],
                         ids=("ppc-16", "ppc-32", "4-words", "2-tiles"))
def test_chunk_txn_claim_kernel_matches_plain(emu, bw, ppc):
    """The emulated ``chunk_txn_claim`` gives the plain claim's page
    indices, row and count for takes of 0, a few, and past the free
    bits, on a row spanning two tiles of 1024 words."""
    rng = np.random.default_rng(bw)
    for take in (0, 3, 40, 10 ** 6):
        row = _i32(rng.integers(0, 2 ** 32, bw, dtype=np.uint64)
                   .astype(np.uint32).view(np.int32))
        want = ref.chunk_txn_claim_ref(row, take, ppc)
        pidx = torch.full((32 * bw,), 777, dtype=torch.int32)
        nrow = torch.empty(bw, dtype=torch.int32)
        nsel = torch.empty(1, dtype=torch.int32)
        emu.emu_chunk_txn_claim(_p(row), bw, take, ppc, _p(pidx), _p(nrow),
                                _p(nsel))
        for g, w in zip((pidx, nrow, nsel), want):
            assert torch.equal(g, w), take


@pytest.mark.parametrize("W", (32, 64, 1056),
                         ids=("32-words", "64-words", "1056-words-2-tiles"))
def test_bitmap_select_kernel_matches_plain(emu, W):
    """The emulated ``bitmap_select`` gives the plain rank map with the
    prefix carried across tiles of 1024 words, for k of 0, 1, 100 and
    past every set bit."""
    rng = np.random.default_rng(W)
    words = _i32(rng.integers(0, 2 ** 32, W, dtype=np.uint64)
                 .astype(np.uint32).view(np.int32))
    for k in (0, 1, 100, 10 ** 6):
        want = ref.bitmap_select_ref(words, k)
        got = torch.empty(32 * W, dtype=torch.int32)
        emu.emu_bitmap_select(_p(words), W, k, _p(got))
        assert torch.equal(got, want), k
