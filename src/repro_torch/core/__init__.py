"""Ouroboros core (port): the dynamic memory manager over one flat
int32 arena, as PyTorch tensors with CUDA transaction kernels."""
from repro_torch.core.arena import Arena, ArenaLayout
from repro_torch.core.heap import HeapConfig
from repro_torch.core.ouroboros import Ouroboros, VARIANTS

__all__ = ["Arena", "ArenaLayout", "HeapConfig", "Ouroboros", "VARIANTS"]
