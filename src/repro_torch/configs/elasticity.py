"""The paper's own workload as a first-class config: matrix-free
high-order linear elasticity on the two-material beam, solved with
GMG-PCG and the PAop operator.

Shapes mirror the paper's problem scales (Sec. 5): the 6.5M-DoF and
51.17M-DoF studies.  At p=8 the coarse 8x1x1 beam refined r times gives
(8*2^r*8+1)(2^r*8+1)^2 * 3 vector DoFs: r=3 -> 6.5M, r=4 -> 51.17M —
exactly the paper's sizes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ElasticityConfig:
    name: str = "elasticity"
    family: str = "fem"
    p: int = 8
    n_h_refine: int = 3
    assembly: str = "paop"
    dtype: str = "float32"


CONFIG = ElasticityConfig()


@dataclasses.dataclass(frozen=True)
class ElasticityShape:
    name: str
    kind: str  # operator | solve
    p: int
    n_h_refine: int


# The paper's two problem scales (Fig. 6) plus the p=2 low-order point.
ELASTICITY_SHAPES = {
    "beam_p2_6m": ElasticityShape("beam_p2_6m", "operator", p=2, n_h_refine=5),
    "beam_p8_6m": ElasticityShape("beam_p8_6m", "operator", p=8, n_h_refine=3),
    "beam_p8_51m": ElasticityShape("beam_p8_51m", "operator", p=8, n_h_refine=4),
}


def reduced() -> ElasticityConfig:
    return ElasticityConfig(name="elasticity-reduced", p=2, n_h_refine=1)
