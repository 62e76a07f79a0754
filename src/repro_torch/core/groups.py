"""Masked group operations: the allocator's lane-aggregation machinery.

``masked_rank`` is warp-aggregated allocation generalised to the
request vector: one queue-counter update per size class, not per
request.  The CUDA transaction kernel computes the same ranks with a
block-wide scan (``csrc/alloc_txn.cu``).
"""
from __future__ import annotations

import torch


def masked_prefix_sum(x, mask):
    """Exclusive prefix sum over active lanes only (inactive lanes: 0)."""
    x = torch.where(mask, x, torch.zeros_like(x))
    return torch.cumsum(x, 0).to(x.dtype) - x


def masked_rank(cls, mask, num_classes: int):
    """Rank of each active lane among earlier active lanes of the same
    class, and the per-class active counts.  A lane whose class lies
    outside ``[0, num_classes)`` is ranked in class ``cls % num_classes``
    without being counted there (the reference's one-hot semantics)."""
    cls = cls.to(torch.int32)
    ar = torch.arange(num_classes, dtype=torch.int32, device=cls.device)
    onehot = ((cls[:, None] == ar[None, :]) & mask[:, None]).to(torch.int32)
    if cls.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int32, device=cls.device)
        return z, torch.zeros(num_classes, dtype=torch.int32,
                              device=cls.device)
    inc = torch.cumsum(onehot, 0).to(torch.int32)
    col = (cls % num_classes).to(torch.int64)[:, None]
    rank = torch.gather(inc - onehot, 1, col)[:, 0]
    rank = torch.where(mask, rank, torch.zeros_like(rank))
    return rank.to(torch.int32), inc[-1].to(torch.int32)


def segment_counts(cls, mask, num_classes: int):
    """Per-class active-lane counts (no ranks needed)."""
    ar = torch.arange(num_classes, dtype=torch.int32, device=cls.device)
    onehot = (cls.to(torch.int32)[:, None] == ar[None, :]) & mask[:, None]
    return onehot.sum(0).to(torch.int32)
