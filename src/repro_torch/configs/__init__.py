"""Arch registry: importing this package registers the ported archs."""
from repro_torch.configs.base import ARCH_REGISTRY, ModelConfig, get_arch
from repro_torch.configs import (  # noqa: F401
    mamba2_780m, mixtral_8x7b, phi3_5_moe, qwen1_5_32b, qwen2_0_5b)

__all__ = ["ARCH_REGISTRY", "ModelConfig", "get_arch"]
