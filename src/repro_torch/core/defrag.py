"""Fragmentation observability (port of the reference's
``frag_stats_math`` and ``_pool_members``).  The defragmentation wave
itself (``plan_math``/``migrate_math``) is ROADMAP item A10."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import arena
from repro_torch.core.heap import HeapConfig


def _occupancy_bits(bitmap):
    """(nc, bw) int32 words → (nc, bw·32) bool, bit order LSB-first."""
    nc, bw = bitmap.shape
    sh = torch.arange(32, device=bitmap.device)
    bits = (bitmap.to(torch.int64)[:, :, None] >> sh[None, None, :]) & 1
    return bits.reshape(nc, bw * 32).bool()


def _pool_members(cfg: HeapConfig, pool):
    """Bool mask over chunk ids: currently queued in the free pool."""
    nc = cfg.num_chunks
    dev = pool.store.device
    cnt = (pool.back - pool.front)[0]
    k = torch.arange(nc, dtype=torch.int64, device=dev)
    slots = (pool.front[0].to(torch.int64) + k) % nc
    ids = pool.store[0, slots].to(torch.int64)
    live = (k < cnt) & (ids >= 0) & (ids < nc)
    out = torch.zeros(nc, dtype=torch.bool, device=dev)
    out[ids[live]] = True
    return out


def frag_stats_math(cfg: HeapConfig, kind: str, family: str, mem, ctl):
    """``(free_words, largest_free_extent)`` of one chunk-kind arena: a
    word is free iff its chunk sits in the pool or it belongs to a free
    page of a bound chunk; the largest extent is the longest run."""
    if kind != "chunk":
        raise NotImplementedError(
            "frag stats of page kinds come with them (ROADMAP A3)")
    lay = arena.layout(cfg, kind, family)
    C = cfg.num_classes
    _, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    dev = mem.device
    wpc = cfg.words_per_chunk
    maxbits = cfg.bitmap_words_per_chunk * 32
    occ = _occupancy_bits(meta.bitmap)
    bound = meta.chunk_class >= 0
    cc = torch.clamp(meta.chunk_class, 0, C - 1).to(torch.int64)
    pw = torch.full_like(cc, cfg.page_words(0)) << cc
    ppc = torch.full_like(cc, cfg.max_pages_per_chunk) >> cc
    bit_ix = torch.arange(maxbits, device=dev)
    free_page = (~occ) & bound[:, None] & (bit_ix[None, :] < ppc[:, None])
    word_page = torch.clamp(
        torch.arange(wpc, device=dev)[None, :] // pw[:, None],
        max=maxbits - 1)
    in_pool = _pool_members(cfg, ctx.pool)
    free_mask = (in_pool[:, None]
                 | (bound[:, None]
                    & torch.gather(free_page, 1, word_page))).reshape(-1)
    idx = torch.arange(free_mask.shape[0], dtype=torch.int64, device=dev)
    blocked = torch.where(~free_mask, idx, torch.full_like(idx, -1))
    last_blocked = torch.cummax(blocked, 0).values
    run = torch.where(free_mask, idx - last_blocked, torch.zeros_like(idx))
    return free_mask.sum(), run.max()


def frag_ratio(free_words, largest_free_extent):
    """``1 − largest_free/total_free``: 0 = one solid free block."""
    fw = int(free_words)
    if fw <= 0:
        return 0.0
    # float32, as the reference computes it
    r = np.float32(1.0) - np.float32(int(largest_free_extent)) \
        / np.float32(max(fw, 1))
    return float(r)
