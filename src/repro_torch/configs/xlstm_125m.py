"""xLSTM-125M [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks (the xLSTM[7:1]-style mix; block indices 5 and 11 carry the
sLSTM).  Sub-quadratic: runs the long_500k cell.  [arXiv:2405.04517]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern="xlstm",
    slstm_indices=(5, 11),
    ssm_expand=2,
    ssm_head_dim=192,  # d_inner / n_heads = 1536 / 8? heads act per-block
    chunk_size=256,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="xlstm-125m-reduced",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        vocab=256,
        slstm_indices=(1,),
        ssm_head_dim=16,
        chunk_size=16,
    )
