"""The CUDA emulation harness of the port's kernel tests, and what the
emulated-kernel test files share.

``emu`` (a module-scoped fixture: import it into a test module) builds
``harness.cpp`` with the host C++ compiler against the kernel bodies of
``src/repro_torch/csrc/*.cu`` (each source cut at its host launchers,
its dynamic shared array pointed at the emulation's per-launch buffer)
and returns the library with every entry point typed.  It skips when no
C++20 host compiler is available.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels.alloc_txn import FREE_STATS, ArenaDesc

EMU = pathlib.Path(__file__).resolve().parent
ROOT = EMU.parents[1]
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
    (out / "defrag_emu.inc").write_text(
        _device_part((CSRC / "defrag_txn.cu").read_text()))
    (out / "attention_emu.inc").write_text(
        _device_part((CSRC / "paged_attention.cu").read_text()))
    (out / "ssd_emu.inc").write_text(
        _device_part((CSRC / "ssd_scan.cu").read_text()))
    (out / "ring_emu.inc").write_text(
        _device_part((CSRC / "ring_txn.cu").read_text()))
    (out / "bitmap_emu.inc").write_text(
        _device_part((CSRC / "bitmap_txn.cu").read_text()))
    lib = out / "libemu.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           f"-I{EMU / 'include'}", f"-I{EMU}", f"-I{out}", f"-I{CSRC}",
           "-o", str(lib),
           str(EMU / "harness.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "c++20" in r.stderr.lower():
        pytest.skip(f"host compiler lacks C++20: {r.stderr[:200]}")
    assert r.returncode == 0, r.stderr
    so = ctypes.CDLL(str(lib))
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    so.emu_alloc_txn.argtypes = [ArenaDesc, P, P, P, P, I, P, Z]
    so.emu_free_txn.argtypes = [ArenaDesc, P, P, P, P, P, I, Z]
    so.emu_defrag_txn.argtypes = [ArenaDesc, P, P, P, P, P, I, I, Z]
    so.emu_paged_attention.argtypes = [I, I, P, P, P, P, P, P] + [I] * 8 + [
        ctypes.c_float]
    so.emu_paged_attention_window.argtypes = [I, I] + [P] * 6 + [I] * 10 + [
        ctypes.c_float]
    so.emu_paged_attention_int8.argtypes = [I, I] + [P] * 8 + [I] * 10 + [
        ctypes.c_float]
    so.emu_sharded_alloc_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                         I, I, P, Z]
    so.emu_sharded_free_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                        I, Z]
    so.emu_sharded_defrag_txn.argtypes = [ArenaDesc, P, P, I, I, I, P, P, P,
                                          I, I, Z]
    so.defrag_txn_workspace_bytes.argtypes = [ArenaDesc, I, Z]
    so.defrag_txn_workspace_bytes.restype = Z
    so.sharded_alloc_txn_grid.argtypes = [ArenaDesc, I, Z]
    so.sharded_alloc_txn_grid.restype = I
    so.emu_ssd_scan.argtypes = [I] + [P] * 8 + [I] * 8
    for name in ("alloc_txn", "sharded_alloc_txn"):
        fn = getattr(so, f"{name}_workspace_bytes")
        fn.argtypes, fn.restype = [ArenaDesc, I, Z], Z
    so.free_txn_workspace_bytes.argtypes = [ArenaDesc, I, I, Z]
    so.free_txn_workspace_bytes.restype = Z
    so.emu_ring_txn_pop.argtypes = [P] * 5 + [I] * 4 + [P] * 2
    so.emu_ring_txn_push.argtypes = [P] * 5 + [I] * 3 + [P]
    so.emu_ring_window.argtypes = [P] * 3 + [I] * 3 + [P]
    so.emu_chunk_txn_claim.argtypes = [P] + [I] * 3 + [P] * 3
    so.emu_bitmap_select.argtypes = [P, I, I, P]
    so.emu_alloc_chain_stats.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), I]
    so.emu_alloc_chain_stats.restype = I
    so.emu_free_enqueue_stats.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), I]
    so.emu_free_enqueue_stats.restype = I
    for name in ("emu_alloc_shard_stats", "emu_defrag_rebuild_stats",
                 "emu_launch_stats", "emu_ring_launch_stats"):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), I]
        fn.restype = I
    for f in (so.emu_alloc_txn, so.emu_free_txn, so.emu_defrag_txn,
              so.emu_paged_attention, so.emu_paged_attention_window,
              so.emu_paged_attention_int8,
              so.emu_sharded_alloc_txn,
              so.emu_sharded_free_txn, so.emu_sharded_defrag_txn,
              so.emu_ssd_scan, so.emu_ring_txn_pop, so.emu_ring_txn_push,
              so.emu_ring_window, so.emu_chunk_txn_claim,
              so.emu_bitmap_select):
        f.restype = None
    return so


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


# A lowered shared-memory limit for the lane tables: every transaction
# of a small trace then keeps its tables in the device workspace, as a
# transaction of hundreds of thousands of lanes does at the real limit.
SPILL = 16


# a sharded arena of the engine's geometry: 4 shards x 12 chunks
SHARD_CFG = dict(total_bytes=4 * 12 * 4096, chunk_bytes=4096,
                 min_page_bytes=256)


def _stats(fn, names) -> dict:
    """An emulated kernel family's device counters, read and cleared."""
    buf = (ctypes.c_ulonglong * len(names))()
    assert fn(buf, 1) == len(names)
    return dict(zip(names, (int(v) for v in buf)))


# ---- the other five variants: page kinds, ring and va families -------------

OTHER_VARIANTS = ("page", "chunk", "va_page", "vl_page", "va_chunk")


# ---- the chunk chain's whole-chunk runs ------------------------------------

CHUNK_VARIANTS = ("chunk", "va_chunk", "vl_chunk")


def _run_lanes(rng, n, size, other, p_other=0.15, p_off=0.05):
    """``n`` lanes, most of ``size`` bytes, some of ``other``, a few
    masked off."""
    sizes = np.where(rng.random(n) < p_other, other, size).astype(np.int32)
    return (torch.from_numpy(sizes),
            torch.from_numpy(rng.random(n) >= p_off))


def _free_stats(emu):
    """The emulated free kernels' enqueue statistics since the last call
    (read and cleared), by ``FREE_STATS`` name."""
    buf = (ctypes.c_ulonglong * len(FREE_STATS))()
    assert emu.emu_free_enqueue_stats(buf, 1) == len(FREE_STATS)
    return dict(zip(FREE_STATS, (int(v) for v in buf)))
