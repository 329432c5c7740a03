"""Architecture configuration, copied from the reference's
``repro.configs.base`` so that the port imports nothing of it.

``ArchConfig``, ``ShapeConfig`` and ``SHAPES`` are the reference's, field
for field.  The registry knows every architecture id and alias of the
reference, and holds each one's configuration module (``elasticity``'s is
the solver's :class:`~repro_torch.configs.elasticity.ElasticityConfig`);
an unknown id raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "ALIASES", "PORTED",
           "get_config", "get_reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | ssm | hybrid | vlm | moe | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA width (mixtral)
    head_dim: Optional[int] = None
    rope_theta: float = 1e6
    pos_embed: str = "rope"  # rope | mrope | sinusoidal
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl (t, h, w) half-dim split

    # mlp
    mlp_type: str = "swiglu"  # swiglu | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # ssm / hybrid
    block_pattern: str = "attn"  # attn | xlstm | mamba2 | zamba2
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    slstm_indices: tuple[int, ...] = ()  # xlstm: which blocks are sLSTM
    shared_attn_every: int = 0  # zamba2: shared attn block cadence
    chunk_size: int = 256  # SSD / mLSTM chunk length

    # modality
    n_codebooks: int = 0  # musicgen EnCodec codebooks
    n_vision_tokens: int = 0  # qwen2-vl stub frontend

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is runnable (SSM/hybrid/SWA)."""
        return self.block_pattern in ("xlstm", "mamba2", "zamba2") or (
            self.sliding_window is not None
        )

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb = self.n_codebooks * v * d * 2
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.mlp_type == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.is_moe:
            mlp = self.n_experts * (3 * d * f)
        if self.block_pattern == "attn":
            per_layer = attn + mlp
        elif self.block_pattern in ("mamba2", "zamba2"):
            d_in = self.ssm_expand * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
        elif self.block_pattern == "xlstm":
            d_in = self.ssm_expand * d
            per_layer = 2 * d * d_in + d_in * d + 3 * d_in
        else:
            per_layer = attn + mlp
        total = emb + self.n_layers * per_layer
        if self.block_pattern == "zamba2" and self.shared_attn_every:
            total += attn + 3 * d * self.d_ff  # one shared block
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_mlp = self.n_layers * 3 * d * f
        return (
            self.n_params()
            - self.n_layers * self.n_experts * 3 * d * f
            + self.top_k * dense_mlp
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = (
    "qwen15_32b",
    "qwen3_32b",
    "qwen3_17b",
    "granite_8b",
    "xlstm_125m",
    "zamba2_27b",
    "qwen2_vl_7b",
    "olmoe_1b_7b",
    "mixtral_8x7b",
    "musicgen_medium",
    "elasticity",
)

# CLI aliases matching the assignment sheet ids.
ALIASES = {
    "qwen1.5-32b": "qwen15_32b",
    "qwen3-32b": "qwen3_32b",
    "qwen3-1.7b": "qwen3_17b",
    "granite-8b": "granite_8b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-2.7b": "zamba2_27b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "musicgen-medium": "musicgen_medium",
}


# The language-model architectures (every id of ARCH_IDS but elasticity).
PORTED = ("qwen3_17b", "granite_8b", "qwen15_32b", "qwen3_32b", "qwen2_vl_7b",
          "musicgen_medium", "olmoe_1b_7b", "mixtral_8x7b", "zamba2_27b", "xlstm_125m")


def _module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ArchConfig:
    return _module(arch).reduced()
