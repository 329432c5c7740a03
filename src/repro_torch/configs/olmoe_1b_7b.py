"""OLMoE-1B-7B [moe]: 16L d_model=2048 16H (MHA kv=16) d_ff=1024
vocab=50304, 64 experts top-8.  [arXiv:2409.02060; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="olmoe-1b-7b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=256,
        n_experts=8,
        top_k=2,
    )
