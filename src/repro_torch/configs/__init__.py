"""Arch registry: importing this package registers the ported archs."""
from repro_torch.configs.base import ARCH_REGISTRY, ModelConfig, get_arch
from repro_torch.configs import mamba2_780m, qwen2_0_5b  # noqa: F401

__all__ = ["ARCH_REGISTRY", "ModelConfig", "get_arch"]
