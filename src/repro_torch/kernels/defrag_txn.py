"""Wrappers of the CUDA defragmentation wave kernels
(``csrc/defrag_txn.cu``): one launch per migration wave on an arena, or
a sharded arena, of a chunk kind (any queue family) that lies on the
card.

Each wrapper checks devices, dtypes, shapes and contiguity, launches on
the current stream, and raises if the launch reports an error.  A wave
takes an arena of any chunk count: per-chunk tables that do not fit in
a block's shared memory go to a device workspace
(``alloc_txn.workspace``).  ``mem``
and ``ctl`` are updated in place.  The plain versions are
``core/defrag.migrate_math`` / ``sharded_migrate_math``;
``kernels/ops`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.alloc_txn import (TABLE_SMEM_LIMIT, ArenaDesc,
                                           _check, _prepare, _ptr, _stream,
                                           workspace)


def _lib():
    lib = build.load("defrag_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.defrag_txn_launch.argtypes = [ArenaDesc, P, P, P, P, P, I, P, P]
        lib.defrag_txn_launch.restype = I
        lib.sharded_defrag_txn_launch.argtypes = [ArenaDesc, P, P, I, I, I,
                                                  P, P, P, I, P, P]
        lib.sharded_defrag_txn_launch.restype = I
        lib.defrag_txn_workspace_bytes.argtypes = [ArenaDesc,
                                                   ctypes.c_size_t]
        lib.defrag_txn_workspace_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _wave(cfg, kind, family, mem, ctl, src, dst, sizes, num_shards=None):
    if kind != "chunk":
        raise ValueError("page kinds bind no chunks: their waves are no-ops "
                         "and launch nothing")
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl, num_shards)
    M = src.shape[0]
    for name, t in (("src", src), ("dst", dst), ("sizes", sizes)):
        _check(name, t, torch.int32, (M,), dev)
    lib = _lib()
    ws = workspace(lib.defrag_txn_workspace_bytes(desc, TABLE_SMEM_LIMIT),
                   dev)
    return lay, desc, dev, M, lib, ws


def arena_defrag_txn(cfg, kind, family, mem, ctl, src, dst, sizes):
    """One migration wave in one launch (``mem``/``ctl`` in place).
    ``src``/``dst``/``sizes`` (M,) int32: the forwarding table of
    ``defrag.plan_math``, whose sources and destinations are
    disjoint."""
    lay, desc, dev, M, lib, ws = _wave(cfg, kind, family, mem, ctl, src,
                                       dst, sizes)
    err = lib.defrag_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                                src.data_ptr(), dst.data_ptr(),
                                sizes.data_ptr(), M, _ptr(ws), _stream(dev))
    if err:
        raise RuntimeError(f"defrag_txn launch failed: CUDA error {err}")
    ops.count("defrag_txn")


def sharded_arena_defrag_txn(cfg, num_shards, kind, family, mem, ctl, src,
                             dst, sizes):
    """One sharded migration wave in one launch (``mem``/``ctl`` (S, ·)
    in place); ``src``/``dst`` are GLOBAL offsets of a plan from
    ``defrag.sharded_plan_math`` or ``shards.rebalance_plan_math``."""
    lay, desc, dev, M, lib, ws = _wave(cfg, kind, family, mem, ctl, src,
                                       dst, sizes, num_shards)
    err = lib.sharded_defrag_txn_launch(
        desc, mem.data_ptr(), ctl.data_ptr(), num_shards, lay.mem_words,
        lay.ctl_words, src.data_ptr(), dst.data_ptr(), sizes.data_ptr(), M,
        _ptr(ws), _stream(dev))
    if err:
        raise RuntimeError(f"sharded_defrag_txn launch failed: CUDA error "
                           f"{err}")
    ops.count("sharded_defrag_txn")
