"""Heap layout for the Ouroboros dynamic memory manager (port).

The heap is a flat int32 word array divided into equal chunks; pages of
a size class are carved out of chunks.  ``HeapConfig`` is pure layout
math (a copy of the reference's); ``size_to_class_device`` and
``_clz32`` are the tensor versions of the reference's device math.
"""
from __future__ import annotations

import dataclasses

import torch

WORD_BYTES = 4


def _log2i(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"expected positive power of two, got {x}")
    return x.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class HeapConfig:
    """Static configuration of the device heap (8 MiB heap, 8 KiB
    chunks, size classes 16 B .. 8 KiB by default)."""

    total_bytes: int = 8 << 20
    chunk_bytes: int = 8 << 10
    min_page_bytes: int = 16
    max_alloc_batch: int = 8192

    def __post_init__(self):
        _log2i(self.chunk_bytes)
        _log2i(self.min_page_bytes)
        if self.total_bytes % self.chunk_bytes:
            raise ValueError("total_bytes must be a multiple of chunk_bytes")
        if self.min_page_bytes < WORD_BYTES:
            raise ValueError("min page must hold at least one word")

    @property
    def num_chunks(self) -> int:
        return self.total_bytes // self.chunk_bytes

    @property
    def words_per_chunk(self) -> int:
        return self.chunk_bytes // WORD_BYTES

    @property
    def total_words(self) -> int:
        return self.total_bytes // WORD_BYTES

    @property
    def num_classes(self) -> int:
        """Size classes are powers of two: min_page .. chunk_bytes."""
        return _log2i(self.chunk_bytes) - _log2i(self.min_page_bytes) + 1

    def page_bytes(self, c: int) -> int:
        return self.min_page_bytes << c

    def page_words(self, c: int) -> int:
        return self.page_bytes(c) // WORD_BYTES

    def pages_per_chunk(self, c: int) -> int:
        return self.chunk_bytes // self.page_bytes(c)

    @property
    def max_pages_per_chunk(self) -> int:
        return self.pages_per_chunk(0)

    @property
    def bitmap_words_per_chunk(self) -> int:
        """Occupancy bitmap words (32 pages tracked per word)."""
        return max(1, self.max_pages_per_chunk // 32)

    @property
    def data_chunks_per_class(self) -> int:
        return max(1, self.num_chunks // (self.num_classes + 1))

    def slots_per_segment(self, family: str) -> int:
        """Queue items one heap-chunk segment holds (vl segments keep
        word 0 for the next pointer)."""
        return self.words_per_chunk - (1 if family == "vl" else 0)


def size_to_class_device(cfg: HeapConfig, sizes: torch.Tensor):
    """Sizes in bytes → int32 class ids; over-large (or negative, i.e.
    >2 GiB after the int32 cast) sizes map to ``num_classes``."""
    raw = sizes.to(torch.int32)
    s = torch.clamp(raw, min=cfg.min_page_bytes)
    bits = 32 - _clz32(s - 1)
    c = bits - _log2i(cfg.min_page_bytes)
    bad = (raw < 0) | (s > cfg.chunk_bytes)
    return torch.where(bad, torch.full_like(c, cfg.num_classes),
                       c).to(torch.int32)


def _clz32(x: torch.Tensor):
    """Count leading zeros of each 32-bit word; clz(0) = 32.  The word
    is read as uint32 (int64 arithmetic, masked to 32 bits)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        mask = x <= (0xFFFFFFFF >> shift)
        n = torch.where(mask, n + shift, n)
        x = torch.where(mask, (x << shift) & 0xFFFFFFFF, x)
    return torch.where(x == 0, torch.full_like(n, 32), n).to(torch.int32)
