"""The port's CUDA kernel sources, compiled for the host and held to
their plain PyTorch versions on the CPU.

``tests/cuda_emu`` emulates the device features the kernels use (a
std::thread per CUDA thread, block and warp barriers, host atomics), so
the kernel bodies of ``src/repro_torch/csrc/*.cu`` run here unchanged,
minus their host launchers.  This checks the kernels' logic — operation
order, indexing, the serial chain and the block-wide scans — on every
run; the card itself checks compilation for sm_90a and real
concurrency (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Skips
when no C++20 host compiler is available.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import HeapConfig, Ouroboros
from repro_torch.kernels import ref
from repro_torch.kernels.alloc_txn import ArenaDesc, descriptor

ROOT = pathlib.Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
MARK = "// ---- host launchers"


def _device_part(src: str) -> str:
    """Kernel source without its host launchers; the dynamic shared
    array points at the emulation's per-launch buffer."""
    assert MARK in src, "kernel source lost its host-launcher marker"
    src = src[:src.index(MARK)]
    return re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_dyn_smem;", src)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "alloc_emu.inc").write_text(
        _device_part((CSRC / "alloc_txn.cu").read_text()))
    (out / "attention_emu.inc").write_text(
        _device_part((CSRC / "paged_attention.cu").read_text()))
    lib = out / "libemu.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           f"-I{EMU / 'include'}", f"-I{EMU}", f"-I{out}", "-o", str(lib),
           str(EMU / "harness.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "c++20" in r.stderr.lower():
        pytest.skip(f"host compiler lacks C++20: {r.stderr[:200]}")
    assert r.returncode == 0, r.stderr
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.emu_alloc_txn.argtypes = [ArenaDesc, P, P, P, P, I, P]
    so.emu_free_txn.argtypes = [ArenaDesc, P, P, P, P, P, I]
    so.emu_paged_attention.argtypes = [I, P, P, P, P, P, P] + [I] * 8 + [
        ctypes.c_float]
    for f in (so.emu_alloc_txn, so.emu_free_txn, so.emu_paged_attention):
        f.restype = None
    return so


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("cfgkw,menu,n,ops_,bias", [
    (dict(total_bytes=1 << 16, chunk_bytes=1 << 11, min_page_bytes=16),
     [16, 24, 100, 256, 1000, 2048, 8192], 16, 20, 0.6),
    (dict(total_bytes=1 << 16, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64, 128], 16, 24, 0.6),
    (dict(total_bytes=1 << 12, chunk_bytes=64, min_page_bytes=16),
     [16, 32, 64], 64, 40, 0.8),
    (dict(total_bytes=24 * 4096, chunk_bytes=4096, min_page_bytes=256),
     [256, 512, 4096, 8192], 128, 24, 0.6),
], ids=("mixed", "segment-churn", "exhausting", "kv-geometry"))
def test_alloc_kernels_match_plain_math(emu, cfgkw, menu, n, ops_, bias):
    cfg = HeapConfig(**cfgkw)
    o = Ouroboros(cfg, "vl_chunk", device="cpu")
    d = descriptor(o.layout)
    st = o.init()
    mem, ctl = st.mem.clone(), st.ctl.clone()
    rng = np.random.default_rng(7)
    live = []
    for step in range(ops_):
        if not live or rng.random() < bias:
            sizes = torch.from_numpy(rng.choice(menu, n).astype(np.int32))
            mask = torch.from_numpy(rng.random(n) < 0.85)
            st, want = o.alloc(st, sizes, mask)
            got = torch.empty(n, dtype=torch.int32)
            emu.emu_alloc_txn(d, _p(mem), _p(ctl), _p(sizes), _p(mask), n,
                              _p(got))
            assert torch.equal(got, want), step
            live += [(int(a), int(b)) for a, b in
                     zip(want.tolist(), sizes.tolist()) if a >= 0]
        else:
            k = min(len(live), int(rng.integers(1, n + 1)))
            pick = set(rng.choice(len(live), k, replace=False).tolist())
            drop = [x for i, x in enumerate(live) if i in pick]
            live = [x for i, x in enumerate(live) if i not in pick]
            fo = np.full(n, -1, np.int32)
            fs = np.zeros(n, np.int32)
            fo[:k] = [a for a, _ in drop]
            fs[:k] = [b for _, b in drop]
            perm = rng.permutation(n)
            fo_t = torch.from_numpy(fo[perm].copy())
            fs_t = torch.from_numpy(fs[perm].copy())
            fm = fo_t >= 0
            st = o.free(st, fo_t, fs_t, fm)
            emu.emu_free_txn(d, _p(mem), _p(ctl), _p(fo_t), _p(fs_t),
                             _p(fm), n)
        assert torch.equal(mem, st.mem), f"mem differs after op {step}"
        assert torch.equal(ctl, st.ctl), f"ctl differs after op {step}"


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
    emu.emu_paged_attention(int(dtype == torch.bfloat16), _p(q), _p(k),
                            _p(v), _p(tt), _p(st), _p(got), B, Hq, Hkv, D,
                            page, P, NP, int(wpp or 0), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
