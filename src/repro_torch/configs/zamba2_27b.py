"""Zamba2-2.7B [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone with a shared attention+MLP
block applied every 6 layers (weight-shared across all applications, the
Zamba trick).  Sub-quadratic backbone: runs the long_500k cell.
[arXiv:2411.15242; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    block_pattern="zamba2",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    chunk_size=256,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="zamba2-2.7b-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=16,
        shared_attn_every=2,
        chunk_size=16,
    )
