"""Page allocator (paper §4.1, fig. 1) over any queue family: the
piecewise allocator API of the reference's ``core/page_alloc.py``.

Init carves each class's share of the data chunks into pages and
enqueues every page offset.  ``alloc`` is one bulk dequeue of the
inventory-limited rank prefix, ``free`` one bulk enqueue: the fastest
variant, with fragmentation fixed at init.

State is the views of a page-kind arena (``arena.unpack`` of an
``arena.layout(cfg, "page", family)``), updated in place.  With
``piecewise=True`` the device steps go through ``kernels/ops`` (the
``ring`` family's alloc is one ``ring_txn_pop(limit=True)``, its free
one ``ring_txn_push``; the virtualized families' pool pops and pushes
and the ``va`` shrink window likewise): CUDA kernels on the card,
their plain versions on the CPU.  The default route is plain tensor
code, which is also the plain version of the fused transaction kernels
(``csrc/alloc_txn.cu``) for page kinds.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import groups, queues
from repro_torch.core.heap import HeapConfig, size_to_class_device
from repro_torch.kernels import ops


class AllocState(NamedTuple):
    q: Any                 # queue-family state (views)
    ctx: queues.AllocCtx   # heap words + free-chunk pool (views)
    meta: Any              # ChunkMeta views for chunk kinds, None here


def data_chunks_per_class(cfg: HeapConfig) -> int:
    """Even split of the chunks over the classes, one class's share
    held back for virtualized queue segments."""
    return cfg.data_chunks_per_class


def init(cfg: HeapConfig, family_name: str, state: AllocState, *,
         piecewise: bool = False) -> AllocState:
    """Fill the pool with every chunk, empty the class queues, then
    claim each class's share of chunks from the pool and enqueue their
    pages in ascending order (in place on blank arena views)."""
    fam = queues.family(family_name)
    q, ctx, _ = state
    dev = ctx.heap.device
    queues.pool_init(cfg, ctx.pool)
    queues.init_queues(cfg, family_name, q, ctx, piecewise=piecewise)
    share = data_chunks_per_class(cfg)
    for c in range(cfg.num_classes):
        mask = torch.ones(share, dtype=torch.bool, device=dev)
        _, chunk_ids = queues.pool_dequeue(cfg, ctx.pool, mask,
                                           piecewise=piecewise)
        ppc, pw = cfg.pages_per_chunk(c), cfg.page_words(c)
        offs = (chunk_ids[:, None] * cfg.words_per_chunk
                + torch.arange(ppc, dtype=torch.int32, device=dev)[None, :]
                * pw).reshape(-1)
        n = offs.shape[0]
        fam.bulk_enqueue(cfg, q, ctx,
                         torch.full((n,), c, dtype=torch.int32, device=dev),
                         torch.arange(n, dtype=torch.int32, device=dev), offs,
                         torch.ones(n, dtype=torch.bool, device=dev),
                         piecewise=piecewise)
    return state


def alloc(cfg: HeapConfig, family_name: str, state: AllocState, sizes_bytes,
          mask, *, piecewise: bool = False):
    """One bulk alloc.  Returns ``(state, word offsets)``; −1 marks a
    masked, over-large or unserved lane (the GPU original's nullptr).
    Grants are each class's rank prefix that fits its inventory."""
    fam = queues.family(family_name)
    C = cfg.num_classes
    q, ctx, _ = state
    cls = size_to_class_device(cfg, sizes_bytes)
    valid = mask & (cls < C)
    if piecewise and family_name == "ring":
        # one kernel: rank, inventory grant, wrapped pop, front advance
        offs, new_front = ops.ring_txn_pop(q.store, q.front, q.back, cls,
                                           valid, limit=True)
        q.front.copy_(new_front)
        return state, offs
    rank, _ = groups.masked_rank(cls, valid, C)
    avail = fam.count(q)
    grant = valid & (rank < avail[(cls % C).to(torch.int64)])
    _, _, offs = fam.bulk_dequeue(cfg, q, ctx, cls, rank, grant,
                                  piecewise=piecewise)
    return state, offs


def free(cfg: HeapConfig, family_name: str, state: AllocState, offsets_words,
         sizes_bytes, mask, *, piecewise: bool = False) -> AllocState:
    """One bulk free; masked, over-large or negative-offset lanes are
    no-ops.  Pages re-enter their class queues in lane order."""
    fam = queues.family(family_name)
    C = cfg.num_classes
    q, ctx, _ = state
    cls = size_to_class_device(cfg, sizes_bytes)
    offs = offsets_words.to(torch.int32)
    valid = mask & (cls < C) & (offs >= 0)
    if piecewise and family_name == "ring":
        _, new_back = ops.ring_txn_push(q.store, q.back, cls,
                                        offs.contiguous(), valid)
        q.back.copy_(new_back)
        return state
    rank, _ = groups.masked_rank(cls, valid, C)
    fam.bulk_enqueue(cfg, q, ctx, cls, rank, offs, valid, piecewise=piecewise)
    return state
