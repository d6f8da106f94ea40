"""Unified architecture configuration covering the 10 assigned families
(the JAX package's ``repro.models.config``, unchanged)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qkv_bias: bool = False
    activation: str = "silu"     # "gelu" => GeGLU-style gated GELU
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert hidden (0 => d_ff)
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    v_head_dim: int = 0
    # hybrid / SSM
    ssm_state: int = 0
    mamba_per_attn: int = 0      # zamba2: mamba layers per shared-attn block
    xlstm: bool = False
    # encoder-decoder (audio)
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub (assignment: precomputed embeddings)
    frontend: str = ""           # "" | "vision" | "audio"
    frontend_dim: int = 0
    frontend_len: int = 0
    # capabilities
    sub_quadratic: bool = False  # may run long_500k
    has_decoder: bool = True
    # numerics
    dtype: str = "bfloat16"

    @property
    def eff_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 for clean TP sharding."""
        return -(-self.vocab_size // 256) * 256

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention; decode
    shapes need a decoder."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full-attention arch: long_500k skipped (see DESIGN.md)"
    if shape.kind == "decode" and not arch.has_decoder:
        return False, "encoder-only arch: no decode step"
    return True, ""
