"""MusicGen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens (4 codebooks with the delay
pattern; the EnCodec frontend is a STUB — input_specs provides the
(B, S, 4) code tokens directly, embeddings are summed over codebooks and
4 parallel LM heads predict the next codes).  GELU MLP, sinusoidal
positions.  [arXiv:2306.05284; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp_type="gelu",
    pos_embed="sinusoidal",
    n_codebooks=4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="musicgen-medium-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=64,
        n_codebooks=4,
    )
