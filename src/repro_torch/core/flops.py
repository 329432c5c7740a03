"""Analytic FLOP counts for the elasticity operator (paper Table 5).

:func:`default_q1d` is the single source of the 1D quadrature count;
the kernel's bound in ``chip_smoke.py`` and ``PERF.md`` is derived from
:func:`paop_flops_per_elem`.
"""

from __future__ import annotations

__all__ = ["default_q1d", "paop_flops_per_elem"]


def default_q1d(p: int) -> int:
    """1D quadrature-point count for degree ``p``: the paper's p+2
    Gauss rule (exact for the bilinear-form integrand on affine cells)."""
    return p + 2


def paop_flops_per_elem(p: int, q1d: int | None = None) -> float:
    """Closed-form multiply+add count of the PAop kernel per element
    (d=3 vector elasticity; forward + pointwise Voigt + backward)."""
    D = p + 1
    Q = default_q1d(p) if q1d is None else q1d
    fwd = 3 * 2 * (
        2 * (Q * D * D * D)     # X contraction: u, v channels
        + 3 * (Q * Q * D * D)   # Y: d_xi, d_eta, u_xy
        + 3 * (Q * Q * Q * D)   # Z
    )
    geom = 2 * 9 * Q**3 * 2     # J^-T pullback, forward + backward
    stress = 24 * Q**3          # structured Voigt arithmetic (Sec. 4.3)
    bwd = 3 * 2 * (
        3 * (Q * Q * Q * D) + 3 * (Q * Q * D * D) + 3 * (Q * D * D * D)
    )
    return float(fwd + geom + stress + bwd)
