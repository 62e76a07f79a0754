"""The Mamba-2 SSD chunked scan: the wrapper of the CUDA kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch version.

``x`` (B, L, H, P) in bf16 or float32; ``dt`` (B, L, H) float32; ``a``
(H,) float32; ``b``, ``c`` (B, L, G, N) in ``x``'s dtype, head h reading
group h // (H / G); ``h0`` (B, H, P, N) float32 or None.  Both return
``(y (B, L, H, P) float32, h_final (B, H, P, N) float32)``.

:func:`ssd_plain` is a PyTorch mirror of the reference's
``models/ssm.py::ssd_jnp`` (it pads L to a multiple of the chunk with
dt = 0, which is inert); :func:`ssd_scan` launches the kernels (C B^T
per chunk and group beside the chunk states per chunk and head, the
serial pass over chunks, the outputs per chunk and head) and takes L a
multiple of the chunk.
``kernels/ops.ssd_scan`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ops

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK, MAX_HEADDIM, MAX_STATE = 64, 64, 128  # the kernel's tiles


def ssd_plain(x, dt, a, b, c, chunk: int, h0=None):
    """Chunked SSD in plain tensor ops, chunk by chunk (the reference's
    ``ssd_jnp``)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    q = chunk
    pad = (-L) % q
    if pad:
        # dt = 0 on padding: decay 1, zero input, mathematically inert
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // q
    xr = x.reshape(B, nc, q, H, P).float()
    dtr = dt.reshape(B, nc, q, H).float()
    br = b.reshape(B, nc, q, G, N).float()
    cr = c.reshape(B, nc, q, G, N).float()
    cum = torch.cumsum(dtr * a.float()[None, None, None, :], dim=2)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for k in range(nc):
        xc, dtc, bc, cc, cumc = (xr[:, k], dtr[:, k], br[:, k], cr[:, k],
                                 cum[:, k])
        decay = torch.exp(cumc[:, :, None, :] - cumc[:, None, :, :])
        decay = torch.where(tri[None, :, :, None], decay,
                            torch.zeros_like(decay))
        cb = torch.einsum("bqgn,bkgn->bqkg", cc, bc)
        cb = torch.repeat_interleave(cb, rep, dim=3)         # (B, q, q, H)
        w = cb * decay * dtc[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", w, xc)
        # inter-chunk: y_i += exp(cum_i) C_i^T h_in
        cch = torch.repeat_interleave(cc, rep, dim=2)        # (B, q, H, N)
        y = y + torch.exp(cumc)[..., None] * torch.einsum(
            "bqhn,bhpn->bqhp", cch, h)
        # state update
        wj = torch.exp(cumc[:, -1:, :] - cumc) * dtc         # (B, q, H)
        bch = torch.repeat_interleave(bc, rep, dim=2)
        h = (torch.exp(cumc[:, -1, :])[:, :, None, None] * h
             + torch.einsum("bqhp,bqhn->bhpn", xc * wj[..., None], bch))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nc * q, H, P)[:, :L]
    return y, h


def _lib():
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [I] + [P] * 9 + [I] * 7 + [P]
        lib.ssd_scan_launch.restype = I
        lib.ssd_scan_workspace_floats.argtypes = [I] * 7
        lib.ssd_scan_workspace_floats.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def ssd_scan(x, dt, a, b, c, h0=None, *, chunk: int = 64):
    """The whole chunked scan of every (batch row, head) on the card:
    the kernels' three launches, in order on the current stream, with
    their float32 scratch (C B^T, cumsums, chunk states) from
    ``torch.empty``."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA ssd_scan kernel needs tensors on the "
                         f"card, got {x.device}")
    B, L, H, P = x.shape
    if b.dim() != 4:
        raise ValueError(f"b must be (B, L, G, N), got {tuple(b.shape)}")
    G, N = b.shape[2], b.shape[3]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_DTYPES}")
    if L % chunk:
        raise ValueError(f"L={L} not a multiple of chunk={chunk}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    if not (1 <= chunk <= MAX_CHUNK and P <= MAX_HEADDIM
            and N <= MAX_STATE):
        raise ValueError(f"chunk {chunk}, head dim {P}, state {N} exceed the "
                         f"kernel's {MAX_CHUNK}, {MAX_HEADDIM}, {MAX_STATE}")
    want = {"x": (x, x.dtype, (B, L, H, P)), "dt": (dt, torch.float32,
                                                    (B, L, H)),
            "a": (a, torch.float32, (H,)), "b": (b, x.dtype, (B, L, G, N)),
            "c": (c, x.dtype, (B, L, G, N))}
    if h0 is not None:
        want["h0"] = (h0, torch.float32, (B, H, P, N))
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    y = torch.empty((B, L, H, P), dtype=torch.float32, device=x.device)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(max(1, lib.ssd_scan_workspace_floats(B, L, H, P, G, N,
                                                          chunk)),
                     dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), hf.data_ptr(),
        ws.data_ptr(), B, L, H, P, G, N, chunk,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ops.count("ssd_scan")
    return y, hf
