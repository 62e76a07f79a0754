"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

``q`` (B, Hq, D); ``k_pages``/``v_pages`` (NP, page, Hkv, D) in bf16 or
float32 (the same dtype as ``q``); ``page_table`` (B, P) int32 page ids,
or arena word offsets when ``wpp`` is set; ``seq_lens`` (B,) int32.
Returns (B, Hq, D) float32.  The plain version is
``kernels/ref.paged_attention``; ``kernels/ops`` picks by device.
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
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float, P]
        lib.paged_attention_launch.restype = I
        lib._typed = True
    return lib


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, wpp=None):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA paged attention kernel needs tensors "
                         f"on the card, got {q.device}")
    B, Hq, D = q.shape
    NP, page, Hkv, Dk = k_pages.shape
    P = page_table.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_DTYPES}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
        if tuple(t.shape) != (NP, page, Hkv, D) or Dk != D:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"q's head dim {D}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if tuple(page_table.shape) != (B, P) or tuple(seq_lens.shape) != (B,):
        raise ValueError("page_table must be (B, P) and seq_lens (B,)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wpp is not None and wpp <= 0:
        raise ValueError(f"wpp must be positive, got {wpp}")
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    err = _lib().paged_attention_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, D, page, P, NP, int(wpp or 0),
        1.0 / D ** 0.5,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    ops.count("paged_attention")
    return out
