"""Wrapper of the CUDA ring-window gather (``csrc/ring_txn.cu``
``ring_window_kernel``): ``out[c, j] = store[c, (front[c] + j) mod cap]``
for ``j < counts[c]``, else −1, for a (C, cap) int32 ring store on the
card.  The plain version is ``ref.ring_window_ref``; ``kernels/ops``
picks between them by device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.alloc_txn import (_check, _stream, launched,
                                           on_card, ring_lib)


def ring_window(store, front, counts, *, m: int):
    """The (C, m) window in one launch of a (tiles of m, C) grid.
    Raises if ``m`` exceeds the ring capacity; a window of width 0
    launches nothing."""
    C, cap = store.shape
    if m > cap:
        raise ValueError(f"window {m} exceeds ring capacity {cap}")
    dev = on_card("ring_window", store)
    _check("store", store, torch.int32, (C, cap), dev)
    _check("front", front, torch.int32, (C,), dev)
    _check("counts", counts, torch.int32, (C,), dev)
    out = torch.empty((C, m), dtype=torch.int32, device=dev)
    if m == 0 or C == 0:
        return out
    err = ring_lib().ring_window_launch(store.data_ptr(), front.data_ptr(),
                                        counts.data_ptr(), C, cap, m,
                                        out.data_ptr(), _stream(dev))
    launched("ring_window", err)
    return out
