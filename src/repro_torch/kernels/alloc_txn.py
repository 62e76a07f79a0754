"""Wrappers of the CUDA allocator transaction kernels
(``csrc/alloc_txn.cu``): one launch per whole alloc or free transaction
on an arena that lies on the card.

Each wrapper checks devices, dtypes, shapes and contiguity, allocates
its output with ``torch.empty``, launches on the current stream, and
raises if the launch reports an error.  ``mem`` and ``ctl`` are updated
in place.  The plain version is ``core/transactions.alloc_math`` /
``free_math``; ``kernels/ops`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import arena
from repro_torch.core.heap import _log2i
from repro_torch.core.transactions import check_variant
from repro_torch.kernels import build, ops

_FIELDS = ("total_words", "num_chunks", "wpc", "bw", "num_classes",
           "min_page_log2", "chunk_bytes", "min_page_words", "max_ppc",
           "spc", "pool_off", "bitmap_off", "free_off", "class_off",
           "ctl_words", "core_ctl_words", "wrap_capacity")
MAX_CTL = 256
MAX_CLASSES = 32
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)


class ArenaDesc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _FIELDS]


@functools.lru_cache(maxsize=None)
def descriptor(lay: arena.ArenaLayout) -> ArenaDesc:
    """The kernel's view of an arena layout, built once per layout."""
    cfg = lay.cfg
    if lay.ctl_words > MAX_CTL or lay.num_classes > MAX_CLASSES:
        raise ValueError(f"arena with {lay.num_classes} classes / "
                         f"{lay.ctl_words} ctl words exceeds the kernel's "
                         f"{MAX_CLASSES} / {MAX_CTL}")
    return ArenaDesc(
        total_words=cfg.total_words, num_chunks=cfg.num_chunks,
        wpc=cfg.words_per_chunk, bw=cfg.bitmap_words_per_chunk,
        num_classes=lay.num_classes,
        min_page_log2=_log2i(cfg.min_page_bytes),
        chunk_bytes=cfg.chunk_bytes, min_page_words=cfg.page_words(0),
        max_ppc=cfg.max_pages_per_chunk, spc=cfg.slots_per_segment("vl"),
        pool_off=lay.region("pool_store").offset,
        bitmap_off=lay.region("bitmap").offset,
        free_off=lay.region("free_count").offset,
        class_off=lay.region("chunk_class").offset,
        ctl_words=lay.ctl_words, core_ctl_words=lay.core_ctl_words,
        wrap_capacity=lay.wrap_capacity)


def _lib():
    lib = build.load("alloc_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.alloc_txn_launch.argtypes = [ArenaDesc, P, P, P, P, I, P, P]
        lib.alloc_txn_launch.restype = I
        lib.free_txn_launch.argtypes = [ArenaDesc, P, P, P, P, P, I, P]
        lib.free_txn_launch.restype = I
        lib.alloc_txn_smem_bytes.argtypes = [ArenaDesc, I]
        lib.alloc_txn_smem_bytes.restype = ctypes.c_size_t
        lib.free_txn_smem_bytes.argtypes = [ArenaDesc, I]
        lib.free_txn_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(cfg, kind, family, mem, ctl, n):
    check_variant(kind, family)
    lay = arena.layout(cfg, kind, family)
    dev = mem.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA transaction kernel needs an arena on "
                         f"the card, got {dev}")
    _check("mem", mem, torch.int32, (lay.mem_words,), dev)
    _check("ctl", ctl, torch.int32, (lay.ctl_words,), dev)
    if n > cfg.max_alloc_batch:
        raise ValueError(f"{n} lanes exceed max_alloc_batch "
                         f"{cfg.max_alloc_batch}")
    return lay, descriptor(lay), dev


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def arena_alloc_txn(cfg, kind, family, mem, ctl, sizes_bytes, mask):
    """One alloc transaction in one launch; returns offsets (n,) int32."""
    n = sizes_bytes.shape[0]
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl, n)
    _check("sizes_bytes", sizes_bytes, torch.int32, (n,), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    lib = _lib()
    if lib.alloc_txn_smem_bytes(desc, n) > SMEM_LIMIT:
        raise ValueError(f"{n} lanes need more shared memory than a block "
                         f"has")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.alloc_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                               sizes_bytes.data_ptr(), mask.data_ptr(), n,
                               out.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"alloc_txn launch failed: CUDA error {err}")
    ops.count("alloc_txn")
    return out


def arena_free_txn(cfg, kind, family, mem, ctl, offsets_words, sizes_bytes,
                   mask):
    """One free transaction in one launch (``mem``/``ctl`` in place)."""
    n = offsets_words.shape[0]
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl, n)
    _check("offsets_words", offsets_words, torch.int32, (n,), dev)
    _check("sizes_bytes", sizes_bytes, torch.int32, (n,), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    lib = _lib()
    if lib.free_txn_smem_bytes(desc, n) > SMEM_LIMIT:
        raise ValueError(f"{n} lanes over {cfg.num_chunks} chunks need more "
                         f"shared memory than a block has")
    err = lib.free_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                              offsets_words.data_ptr(),
                              sizes_bytes.data_ptr(), mask.data_ptr(), n,
                              _stream(dev))
    if err:
        raise RuntimeError(f"free_txn launch failed: CUDA error {err}")
    ops.count("free_txn")
