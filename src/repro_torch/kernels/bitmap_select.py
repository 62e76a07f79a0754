"""Wrapper of the CUDA bitmap rank-select (``csrc/bitmap_txn.cu``
``bitmap_select_kernel``): for each bit of a (W,) int32 bitmap on the
card, W a multiple of 32, its rank among the set bits if below ``k``,
else −1.  The plain version is ``ref.bitmap_select_ref``;
``kernels/ops`` picks between them by device and compacts the rank map
to indices (``ops.bitmap_select_indices``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.alloc_txn import (INT32_MAX, _check, _stream,
                                           bitmap_lib, launched, on_card)


def bitmap_select(words, k: int):
    """The (32 W,) rank map in one launch of one block; every call
    launches."""
    W = words.shape[0]
    if W % 32:
        raise ValueError(f"bitmap words {W} % block 32 != 0")
    dev = on_card("bitmap_select", words)
    _check("words", words, torch.int32, (W,), dev)
    out = torch.empty(32 * W, dtype=torch.int32, device=dev)
    err = bitmap_lib().bitmap_select_launch(
        words.data_ptr(), W, max(-1, min(int(k), INT32_MAX)),
        out.data_ptr(), _stream(dev))
    launched("bitmap_select", err)
    return out
