"""Model configuration: the port's own copy of the reference's
``configs/base.py`` (stdlib only).

One flat frozen dataclass; per-arch files instantiate it with the
published numbers and register under their ``--arch`` id.  ``smoke()``
returns the reduced same-family config the CPU tests run.  Only the
fields the ported families read are kept; other families bring theirs
with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ARCH_REGISTRY = {}


def register(cfg: "ModelConfig") -> "ModelConfig":
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> "ModelConfig":
    from repro_torch import configs  # noqa: F401  (registers every arch)
    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, ...]] = None
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    act: str = "silu"                       # silu (SwiGLU) | gelu (GeGLU)
    parallel_block: bool = False
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (recurrentgemma: every `attn_period`-th block is local attn)
    lru_width: Optional[int] = None
    attn_period: int = 3
    local_window: int = 2048

    # encoder-decoder
    enc_layers: int = 0

    # modality frontend stub: None | "vision" | "audio"
    modality: Optional[str] = None

    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's TP-16
        padding; kept so logits and argmax cover the same columns)."""
        return -(-self.vocab_size // 256) * 256

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the reference's
        ``smoke()`` for the fields kept here)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, self.attn_period + 1
                           if self.family == "hybrid" else 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=256,
            head_dim=32,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            ssm_state=min(self.ssm_state, 32),
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=16,
            lru_width=128 if self.lru_width else None,
            local_window=64 if self.family == "hybrid" else self.local_window,
            sliding_window=64 if self.sliding_window else None,
            enc_layers=min(self.enc_layers, 2),
            mrope_sections=(4, 6, 6) if self.mrope_sections else None,
        )
