"""Kernel dispatch and launch counters.

Each public function here routes by the device of its tensors: CUDA
tensors launch the hand-written kernel (``kernels/alloc_txn.py``,
``kernels/paged_attention.py``, which raise on anything the kernel does
not take), CPU tensors run the kernel's plain PyTorch version.  There is
no fallback from the card to the plain version.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launches`` zeroes the
counts before such a run).
"""
from __future__ import annotations

LAUNCHES = {"alloc_txn": 0, "free_txn": 0, "paged_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def _on_cuda(t) -> bool:
    return t.device.type == "cuda"


def arena_alloc_txn(cfg, kind, family, mem, ctl, sizes_bytes, mask):
    """One whole alloc transaction, in place on ``mem``/``ctl``;
    returns the word offsets (−1 = failed lane)."""
    if _on_cuda(mem):
        from repro_torch.kernels import alloc_txn
        return alloc_txn.arena_alloc_txn(cfg, kind, family, mem, ctl,
                                         sizes_bytes, mask)
    from repro_torch.core.transactions import alloc_math
    return alloc_math(cfg, kind, family, mem, ctl, sizes_bytes, mask)[2]


def arena_free_txn(cfg, kind, family, mem, ctl, offsets_words, sizes_bytes,
                   mask):
    """One whole free transaction, in place on ``mem``/``ctl``."""
    if _on_cuda(mem):
        from repro_torch.kernels import alloc_txn
        alloc_txn.arena_free_txn(cfg, kind, family, mem, ctl, offsets_words,
                                 sizes_bytes, mask)
        return
    from repro_torch.core.transactions import free_math
    free_math(cfg, kind, family, mem, ctl, offsets_words, sizes_bytes, mask)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, wpp=None):
    """Paged GQA decode attention, (B, Hq, D) float32.  ``wpp`` set
    means ``page_table`` holds arena word offsets (page = offset // wpp)."""
    if _on_cuda(q):
        from repro_torch.kernels import paged_attention as pa
        return pa.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                                  wpp=wpp)
    from repro_torch.kernels import ref
    return ref.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                               wpp=wpp)
