"""Wrappers of the CUDA defragmentation wave kernels
(``csrc/defrag_txn.cu``): one launch per migration wave on an arena, or
a sharded arena, that lies on the card.

Each wrapper checks devices, dtypes, shapes and contiguity, launches on
the current stream, and raises if the launch reports an error.  ``mem``
and ``ctl`` are updated in place.  The plain versions are
``core/defrag.migrate_math`` / ``sharded_migrate_math``;
``kernels/ops`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.alloc_txn import (SMEM_LIMIT, ArenaDesc, _check,
                                           _prepare, _stream)


def _lib():
    lib = build.load("defrag_txn")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.defrag_txn_launch.argtypes = [ArenaDesc, P, P, P, P, P, I, P]
        lib.defrag_txn_launch.restype = I
        lib.sharded_defrag_txn_launch.argtypes = [ArenaDesc, P, P, I, I, I,
                                                  P, P, P, I, P]
        lib.sharded_defrag_txn_launch.restype = I
        lib.defrag_txn_smem_bytes.argtypes = [ArenaDesc]
        lib.defrag_txn_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _wave(cfg, kind, family, mem, ctl, src, dst, sizes, num_shards=None):
    lay, desc, dev = _prepare(cfg, kind, family, mem, ctl, 0, num_shards)
    M = src.shape[0]
    for name, t in (("src", src), ("dst", dst), ("sizes", sizes)):
        _check(name, t, torch.int32, (M,), dev)
    lib = _lib()
    if lib.defrag_txn_smem_bytes(desc) > SMEM_LIMIT:
        raise ValueError(f"an arena of {lay.cfg.num_chunks} chunks needs "
                         f"more shared memory than a block has")
    return lay, desc, dev, M, lib


def arena_defrag_txn(cfg, kind, family, mem, ctl, src, dst, sizes):
    """One migration wave in one launch (``mem``/``ctl`` in place).
    ``src``/``dst``/``sizes`` (M,) int32: the forwarding table of
    ``defrag.plan_math``, whose sources and destinations are
    disjoint."""
    lay, desc, dev, M, lib = _wave(cfg, kind, family, mem, ctl, src, dst,
                                   sizes)
    err = lib.defrag_txn_launch(desc, mem.data_ptr(), ctl.data_ptr(),
                                src.data_ptr(), dst.data_ptr(),
                                sizes.data_ptr(), M, _stream(dev))
    if err:
        raise RuntimeError(f"defrag_txn launch failed: CUDA error {err}")
    ops.count("defrag_txn")


def sharded_arena_defrag_txn(cfg, num_shards, kind, family, mem, ctl, src,
                             dst, sizes):
    """One sharded migration wave in one launch (``mem``/``ctl`` (S, ·)
    in place); ``src``/``dst`` are GLOBAL offsets of a plan from
    ``defrag.sharded_plan_math`` or ``shards.rebalance_plan_math``."""
    lay, desc, dev, M, lib = _wave(cfg, kind, family, mem, ctl, src, dst,
                                   sizes, num_shards)
    err = lib.sharded_defrag_txn_launch(
        desc, mem.data_ptr(), ctl.data_ptr(), num_shards, lay.mem_words,
        lay.ctl_words, src.data_ptr(), dst.data_ptr(), sizes.data_ptr(), M,
        _stream(dev))
    if err:
        raise RuntimeError(f"sharded_defrag_txn launch failed: CUDA error "
                           f"{err}")
    ops.count("sharded_defrag_txn")
