"""Allocator telemetry: the ctl-block accumulator region (port).

Every arena ctl block carries a fixed-offset telemetry region after the
core counters (``ArenaLayout.tele_fields()``).  The words advance
inside the transaction itself; this module is the plain math the CUDA
kernel reproduces word for word:

``t_alloc[c]`` / ``t_free[c]`` / ``t_fail[c]``  lanes granted / freed /
    failed per class (masked and over-large lanes are not attempts);
``t_wrap[c]``  crossings of ``wrap_capacity`` by the class counters;
``t_grow`` / ``t_shrink``  pool pops / pushes;
``t_pool_wrap``  full turns of the pool ring;
``t_walk[b]``  lanes served at overflow-walk attempt ``b`` (bin 0 for
    a single arena).

Every delta is a function of lane inputs, granted offsets and the core
counters before and after, so ``update`` takes the old ctl snapshot
and advances the live ctl in place.  Counters are monotonic raw
positions; crossings use floor division, as the reference does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import arena
from repro_torch.core._index import wrap32
from repro_torch.core.heap import size_to_class_device


def _counter_deltas(lay, old_ctl, new_ctl):
    C = lay.num_classes
    capw = lay.wrap_capacity
    nc = lay.cfg.num_chunks
    o, n = old_ctl.to(torch.int64), new_ctl.to(torch.int64)
    f0, f1 = o[lay.off_front:lay.off_front + C], n[lay.off_front:
                                                   lay.off_front + C]
    b0, b1 = o[lay.off_back:lay.off_back + C], n[lay.off_back:
                                                 lay.off_back + C]
    d_wrap = (f1 // capw - f0 // capw) + (b1 // capw - b0 // capw)
    pf0, pf1 = o[lay.off_pool_front], n[lay.off_pool_front]
    pb0, pb1 = o[lay.off_pool_back], n[lay.off_pool_back]
    d_pool_wrap = (pf1 // nc - pf0 // nc) + (pb1 // nc - pb0 // nc)
    return d_wrap, pf1 - pf0, pb1 - pb0, d_pool_wrap


def _per_class(lay, cls, sel):
    ar = torch.arange(lay.num_classes, dtype=torch.int32, device=cls.device)
    return ((cls[:, None] == ar[None, :]) & sel[:, None]).sum(0)


def _apply(lay, ctl, d_alloc, d_free, d_fail, d_wrap, d_grow, d_shrink,
           d_pool_wrap, d_walk):
    delta = torch.cat([d_alloc, d_free, d_fail, d_wrap,
                       torch.stack([d_grow, d_shrink, d_pool_wrap]),
                       d_walk]).to(torch.int64)
    tele = arena.tele_of(lay, ctl)
    tele.copy_(wrap32(tele.to(torch.int64) + delta))
    return ctl


def alloc_update(lay, old_ctl, ctl, sizes_bytes, mask, offs, attempt=0):
    """Advance ``ctl``'s telemetry (in place) after one alloc; ``old_ctl``
    is the block as it was before the transaction."""
    C = lay.num_classes
    cls = size_to_class_device(lay.cfg, sizes_bytes)
    attempted = mask & (cls < C)
    served = attempted & (offs >= 0)
    failed = attempted & (offs < 0)
    d_wrap, d_grow, d_shrink, d_pool_wrap = _counter_deltas(lay, old_ctl,
                                                            ctl)
    nbin = min(int(attempt), arena.TELE_WALK_BINS - 1)
    d_walk = torch.zeros(arena.TELE_WALK_BINS, dtype=torch.int64,
                         device=ctl.device)
    d_walk[nbin] = served.sum()
    zc = torch.zeros(C, dtype=torch.int64, device=ctl.device)
    return _apply(lay, ctl, _per_class(lay, cls, served), zc,
                  _per_class(lay, cls, failed), d_wrap, d_grow, d_shrink,
                  d_pool_wrap, d_walk)


def free_update(lay, old_ctl, ctl, sizes_bytes, mask, offs):
    """Advance ``ctl``'s telemetry (in place) after one free."""
    C = lay.num_classes
    cls = size_to_class_device(lay.cfg, sizes_bytes)
    freed = mask & (cls < C) & (offs >= 0)
    d_wrap, d_grow, d_shrink, d_pool_wrap = _counter_deltas(lay, old_ctl,
                                                            ctl)
    zc = torch.zeros(C, dtype=torch.int64, device=ctl.device)
    zw = torch.zeros(arena.TELE_WALK_BINS, dtype=torch.int64,
                     device=ctl.device)
    return _apply(lay, ctl, zc, _per_class(lay, cls, freed), zc, d_wrap,
                  d_grow, d_shrink, d_pool_wrap, zw)


def decode(lay, ctl) -> Dict[str, np.ndarray]:
    """Telemetry fields of one ctl block as named numpy arrays."""
    c = np.asarray(torch.as_tensor(ctl).cpu())
    return {name: c[..., off:off + w] if w > 1 else c[..., off]
            for name, off, w in lay.tele_fields()}


def totals(lay, ctl) -> Dict[str, int]:
    return {name: int(v.sum()) for name, v in decode(lay, ctl).items()}
