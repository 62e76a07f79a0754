"""Allocator transactions over the device-resident arena (port).

Every variant is a ``(kind, family)`` pair and every transaction runs
against one :class:`arena.Arena`.  Two paths share one contract:

``alloc_math`` / ``free_math``  the plain PyTorch transaction: unpack
    the arena into views, run ``chunk_alloc`` and the telemetry update,
    all in place.  The CPU path and the parity tests run it.

``alloc`` / ``free``  the dispatcher: ``kernels/ops`` launches the CUDA
    transaction kernel for an arena on the card and runs the math for
    one on the CPU.  There is no backend or lowering knob: the arena's
    device decides.

Both update ``mem``/``ctl`` in place (the arena is the largest state
the allocator owns, so a transaction never copies it) and return the
same arena.  Only ``(chunk, vl)`` is ported; the other five variants
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core import arena, chunk_alloc
from repro_torch.core.heap import HeapConfig

PORTED = (("chunk", "vl"),)


def check_variant(kind: str, family: str) -> None:
    if (kind, family) in PORTED:
        return
    item = "A3" if kind == "chunk" else "A3 (page kinds)"
    raise NotImplementedError(
        f"allocator variant (kind={kind}, family={family}) is not ported "
        f"yet (ROADMAP {item}); the port serves (chunk, vl)")


def _views(cfg: HeapConfig, kind: str, family: str, mem, ctl):
    lay = arena.layout(cfg, kind, family)
    q, ctx, meta = arena.unpack(lay, arena.Arena(mem, ctl))
    return lay, chunk_alloc.AllocState(q=q, ctx=ctx, meta=meta)


def init(cfg: HeapConfig, kind: str, family: str, device) -> arena.Arena:
    """Fresh arena on ``device``: every chunk queued in the pool, then
    one empty vl segment per class popped from it."""
    check_variant(kind, family)
    lay = arena.layout(cfg, kind, family)
    st = arena.blank(lay, device)
    chunk_alloc.init(cfg, family, _views(cfg, kind, family, st.mem,
                                         st.ctl)[1])
    return st


def alloc_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
               sizes_bytes, mask) -> Tuple:
    """Plain alloc transaction; updates ``mem``/``ctl`` in place and
    returns ``(mem, ctl, offsets)``."""
    from repro_torch.obs import telemetry
    check_variant(kind, family)
    lay, st = _views(cfg, kind, family, mem, ctl)
    old_ctl = ctl.clone()
    _, offs = chunk_alloc.alloc(cfg, family, st, sizes_bytes, mask)
    telemetry.alloc_update(lay, old_ctl, ctl, sizes_bytes, mask, offs)
    return mem, ctl, offs


def free_math(cfg: HeapConfig, kind: str, family: str, mem, ctl,
              offsets_words, sizes_bytes, mask) -> Tuple:
    """Plain free transaction; updates ``mem``/``ctl`` in place."""
    from repro_torch.obs import telemetry
    check_variant(kind, family)
    lay, st = _views(cfg, kind, family, mem, ctl)
    old_ctl = ctl.clone()
    chunk_alloc.free(cfg, family, st, offsets_words, sizes_bytes, mask)
    telemetry.free_update(lay, old_ctl, ctl, sizes_bytes, mask,
                          offsets_words)
    return mem, ctl


def alloc(cfg: HeapConfig, kind: str, family: str, state: arena.Arena,
          sizes_bytes, mask):
    """One bulk alloc transaction: ``(arena, word offsets)``, −1 for a
    failed lane.  The arena is updated in place."""
    from repro_torch.kernels import ops
    offs = ops.arena_alloc_txn(cfg, kind, family, state.mem, state.ctl,
                               sizes_bytes, mask)
    return state, offs


def free(cfg: HeapConfig, kind: str, family: str, state: arena.Arena,
         offsets_words, sizes_bytes, mask):
    """One bulk free transaction (masked or negative-offset lanes are
    no-ops); the arena is updated in place."""
    from repro_torch.kernels import ops
    ops.arena_free_txn(cfg, kind, family, state.mem, state.ctl,
                       offsets_words, sizes_bytes, mask)
    return state
