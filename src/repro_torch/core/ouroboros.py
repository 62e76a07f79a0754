"""Ouroboros allocator facade (port, single arena).

    ouro = Ouroboros(cfg, "vl_chunk", device="cuda")
    state = ouro.init()                                   # core.arena.Arena
    state, offs = ouro.alloc(state, sizes_bytes, mask)    # offs in words
    state = ouro.free(state, offs, sizes_bytes, mask)

Unlike the reference there is no ``backend``/``lowering`` knob: an
arena on the card runs every transaction as one CUDA kernel launch
(``csrc/alloc_txn.cu``), an arena on the CPU runs the plain PyTorch
math.  Both give the same words.  Transactions update the arena in
place and return it.  Sharding (``num_shards``) is ROADMAP item A11.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import arena, defrag as _defrag, transactions
from repro_torch.core.heap import HeapConfig
from repro_torch.device import resolve_device

VARIANTS = ("page", "chunk", "va_page", "vl_page", "va_chunk", "vl_chunk")


def _split(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    if variant in ("page", "chunk"):
        return variant, "ring"
    fam, kind = variant.split("_")
    return kind, fam


@dataclasses.dataclass(frozen=True)
class Ouroboros:
    """Binds a HeapConfig to one paper variant on one device."""
    cfg: HeapConfig
    variant: str
    device: str = "cuda"

    def __post_init__(self):
        kind, family = _split(self.variant)
        transactions.check_variant(kind, family)
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def kind(self) -> str:
        return _split(self.variant)[0]

    @property
    def family(self) -> str:
        return _split(self.variant)[1]

    @property
    def layout(self) -> arena.ArenaLayout:
        return arena.layout(self.cfg, self.kind, self.family)

    def init(self) -> arena.Arena:
        return transactions.init(self.cfg, self.kind, self.family,
                                 self.device)

    def alloc(self, state, sizes_bytes, mask):
        """One bulk allocation: ``(state, word offsets)``; −1 marks a
        failed lane (over-large size or exhausted heap)."""
        return transactions.alloc(self.cfg, self.kind, self.family, state,
                                  sizes_bytes, mask)

    def free(self, state, offsets_words, sizes_bytes, mask):
        return transactions.free(self.cfg, self.kind, self.family, state,
                                 offsets_words, sizes_bytes, mask)

    def heap(self, state):
        """The heap proper (a view into ``state.mem``)."""
        return arena.heap_of(self.layout, state)

    def frag_stats(self, state):
        """``free_words``, ``largest_free_extent`` and ``frag_ratio``
        (``1 − largest/total``) of ``state``, as Python numbers."""
        free, largest = _defrag.frag_stats_math(
            self.cfg, self.kind, self.family, state.mem, state.ctl)
        return {"free_words": int(free),
                "largest_free_extent": int(largest),
                "frag_ratio": _defrag.frag_ratio(free, largest)}
