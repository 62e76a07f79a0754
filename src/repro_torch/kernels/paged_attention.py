"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

``q`` (B, Hq, D) in bf16 or float32; ``k_pages``/``v_pages`` (NP, page,
Hkv, D) in ``q``'s dtype, or int8 with ``k_scale``/``v_scale`` (NP,
page, Hkv) float32 (an element reads as ``float(k8) * scale``);
``page_table`` (B, P) int32 page ids, or arena word offsets when
``wpp`` is set; ``seq_lens`` (B,) int32;
``window`` (None: none) keeps the last ``window`` tokens, ``ring`` reads
the table as a ring (slot j holds the page of the ring's last lap).
Returns (B, Hq, D) float32.  The plain version is
``kernels/ref.paged_attention``; ``kernels/ops`` picks by device.

One call launches three kernels (scores and page maxima, then p and p V
per page, both over the table's pages split across blocks,
:func:`geometry`; then the fold over pages in table order), through a
float32 workspace from ``torch.empty``; it counts as one launch of
``paged_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ops

_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            I, I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
            ctypes.c_float, P]
        lib.paged_attention_launch.restype = I
        lib.paged_attention_workspace_floats.argtypes = [I] * 6
        lib.paged_attention_workspace_floats.restype = ctypes.c_size_t
        lib.paged_attention_geometry.argtypes = [I, I, P, P]
        lib.paged_attention_geometry.restype = None
        lib._typed = True
    return lib


def geometry(page: int, P: int):
    """(pages a split, splits) of a table of ``P`` pages of ``page``
    tokens: the split kernels' grid is B * Hkv * splits blocks."""
    pps, splits = ctypes.c_int(), ctypes.c_int()
    _lib().paged_attention_geometry(page, P, ctypes.byref(pps),
                                    ctypes.byref(splits))
    return pps.value, splits.value


def _check_scales(k_pages, v_pages, k_scale, v_scale):
    """Pages in int8 need both scales, (NP, page, Hkv) float32; other
    pages take none."""
    quant = k_pages.dtype == torch.int8
    given = (k_scale is not None, v_scale is not None)
    if quant and not all(given):
        raise TypeError("int8 pages need both k_scale and v_scale")
    if not quant and any(given):
        raise TypeError(f"scales come only with int8 pages, not "
                        f"{k_pages.dtype}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name} dtype {t.dtype} is not float32")
            if tuple(t.shape) != tuple(k_pages.shape[:3]):
                raise ValueError(f"{name} shape {tuple(t.shape)} is not the "
                                 f"heap's {tuple(k_pages.shape[:3])}")
    return quant


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, wpp=None,
                    window=None, ring=False, k_scale=None, v_scale=None):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA paged attention kernel needs tensors "
                         f"on the card, got {q.device}")
    B, Hq, D = q.shape
    NP, page, Hkv, Dk = k_pages.shape
    P = page_table.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_DTYPES}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"v_pages dtype {v_pages.dtype} differs from "
                        f"k_pages' {k_pages.dtype}")
    if k_pages.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"pages in {k_pages.dtype} with q in {q.dtype}: "
                        f"pages are in q's dtype or int8")
    quant = _check_scales(k_pages, v_pages, k_scale, v_scale)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if tuple(t.shape) != (NP, page, Hkv, D) or Dk != D:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"q's head dim {D}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if tuple(page_table.shape) != (B, P) or tuple(seq_lens.shape) != (B,):
        raise ValueError("page_table must be (B, P) and seq_lens (B,)")
    scales = (("k_scale", k_scale), ("v_scale", v_scale)) if quant else ()
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens),
                    *scales):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wpp is not None and wpp <= 0:
        raise ValueError(f"wpp must be positive, got {wpp}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = _lib()
    ws = torch.empty(lib.paged_attention_workspace_floats(B, Hq, Hkv, D,
                                                          page, P),
                     dtype=torch.float32, device=q.device)
    err = lib.paged_attention_launch(
        int(q.dtype == torch.bfloat16), int(quant), q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        page_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), B, Hq, Hkv, D, page, P, NP,
        int(wpp or 0), int(window or 0), int(bool(ring)), 1.0 / D ** 0.5,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    ops.count("paged_attention")
    return out
