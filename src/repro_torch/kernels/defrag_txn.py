"""Wrapper of the CUDA defragmentation wave kernel
(``csrc/defrag_txn.cu``): one launch per migration wave on an arena that
lies on the card.

The wrapper checks devices, dtypes, shapes and contiguity, launches on
the current stream, and raises if the launch reports an error.  ``mem``
and ``ctl`` are updated in place.  The plain version is
``core/defrag.migrate_math``; ``kernels/ops`` picks between them by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import arena
from repro_torch.core.transactions import check_variant
from repro_torch.kernels import build, ops
from repro_torch.kernels.alloc_txn import (SMEM_LIMIT, ArenaDesc, _check,
                                           _stream, descriptor)


def _lib():
    lib = build.load("defrag_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.defrag_txn_launch.argtypes = [ArenaDesc, P, P, P, P, P, I, P]
        lib.defrag_txn_launch.restype = I
        lib.defrag_txn_smem_bytes.argtypes = [ArenaDesc]
        lib.defrag_txn_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def arena_defrag_txn(cfg, kind, family, mem, ctl, src, dst, sizes):
    """One migration wave in one launch (``mem``/``ctl`` in place).
    ``src``/``dst``/``sizes`` (M,) int32: the forwarding table of
    ``defrag.plan_math``, whose sources and destinations are
    disjoint."""
    check_variant(kind, family)
    lay = arena.layout(cfg, kind, family)
    dev = mem.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA defrag kernel needs an arena on the "
                         f"card, got {dev}")
    _check("mem", mem, torch.int32, (lay.mem_words,), dev)
    _check("ctl", ctl, torch.int32, (lay.ctl_words,), dev)
    M = src.shape[0]
    for name, t in (("src", src), ("dst", dst), ("sizes", sizes)):
        _check(name, t, torch.int32, (M,), dev)
    desc = descriptor(lay)
    lib = _lib()
    if lib.defrag_txn_smem_bytes(desc) > SMEM_LIMIT:
        raise ValueError(f"an arena of {cfg.num_chunks} chunks needs more "
                         f"shared memory than a block has")
    err = lib.defrag_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                                src.data_ptr(), dst.data_ptr(),
                                sizes.data_ptr(), M, _stream(dev))
    if err:
        raise RuntimeError(f"defrag_txn launch failed: CUDA error {err}")
    ops.count("defrag_txn")
