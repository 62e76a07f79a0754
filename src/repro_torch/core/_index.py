"""Out-of-range indexing with the reference's semantics.

The reference gathers with ``mode="fill"`` and scatters with
``mode="drop"``: an index in ``[-n, 0)`` first wraps to ``i + n``, and
an index still outside ``[0, n)`` reads the fill value or drops its
write.  PyTorch raises on such indices, so the port masks explicitly.
Word arithmetic that the reference lets wrap at 32 bits goes through
:func:`wrap32`.
"""
from __future__ import annotations

import torch


def _norm(idx, n: int):
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def gather_fill(src, idx, fill: int):
    """``src[idx]`` along dim 0; out-of-range rows read ``fill``."""
    n = src.shape[0]
    i = _norm(idx, n)
    ok = (i >= 0) & (i < n)
    vals = src[torch.where(ok, i, torch.zeros_like(i))]
    okb = ok.reshape(ok.shape + (1,) * (vals.dim() - ok.dim()))
    return torch.where(okb, vals, torch.full_like(vals, fill))


def gather_clamp(src, idx):
    """``src[idx]`` along dim 0 with plain-indexing semantics: an index
    in ``[-n, 0)`` wraps, anything else out of range clamps."""
    n = src.shape[0]
    return src[torch.clamp(_norm(idx, n), 0, n - 1)]


def gather2_fill(src, i0, i1, fill: int):
    """``src[i0, i1]`` of a 2-D tensor; out-of-range reads ``fill``."""
    n0, n1 = src.shape
    a, b = _norm(i0, n0), _norm(i1, n1)
    ok = (a >= 0) & (a < n0) & (b >= 0) & (b < n1)
    z = torch.zeros_like(a)
    vals = src[torch.where(ok, a, z), torch.where(ok, b, z)]
    return torch.where(ok, vals, torch.full_like(vals, fill))


def scatter_drop_(dst, idx, vals):
    """``dst[idx] = vals`` in place along dim 0; out-of-range writes
    are dropped.  ``vals`` broadcasts against ``idx``."""
    n = dst.shape[0]
    i = _norm(idx, n)
    vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device)
    vals = torch.broadcast_to(vals, i.shape)
    ok = (i >= 0) & (i < n)
    dst[i[ok]] = vals[ok]
    return dst


def wrap32(x):
    """int64 → int32 with two's-complement wraparound."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
