"""Qwen2-VL-7B [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (t/h/w sections 16/24/24 on the 64 half-dim pairs),
dynamic-resolution vision.  The vision frontend is a STUB: input_specs
provides precomputed patch embeddings; the transformer backbone is what
this config exercises.  [arXiv:2409.12191; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    pos_embed="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    n_vision_tokens=256,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen2-vl-7b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        mrope_sections=(2, 3, 3),
        n_vision_tokens=8,
    )
