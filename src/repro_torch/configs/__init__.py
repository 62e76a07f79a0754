"""Arch registry: importing this package registers the ported archs."""
from repro_torch.configs.base import ARCH_REGISTRY, ModelConfig, get_arch
from repro_torch.configs import (  # noqa: F401
    command_r_35b, internlm2_20b, mamba2_780m, mixtral_8x7b, phi3_5_moe,
    qwen1_5_32b, qwen2_0_5b, qwen2_vl_2b, recurrentgemma_9b,
    seamless_m4t_large_v2)

__all__ = ["ARCH_REGISTRY", "ModelConfig", "get_arch"]
