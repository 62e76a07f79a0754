"""Device resolution for the port's entry points.

Every entry point (``Ouroboros``, ``Model.init``, ``ServingEngine``,
``launch/serve.py``) defaults to ``device="cuda"`` and resolves it
here.  A CUDA request on a machine without a card raises: the port
never silently runs its plain CPU versions in place of the kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run the plain "
            f"PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; "
                         f"use 'cuda' or 'cpu'")
    return dev
