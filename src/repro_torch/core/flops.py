"""Analytic FLOP counts for the elasticity operator (paper Table 5).

:func:`default_q1d` is the single source of the 1D quadrature count;
the kernel's bound in ``chip_smoke.py`` and ``PERF.md`` is derived from
:func:`paop_flops_per_elem`, and the operator-throughput rows
(:mod:`repro_torch.obs.throughput`) from it or, for ``pa_baseline``,
:func:`dense_flops_per_elem`.
"""

from __future__ import annotations

__all__ = [
    "default_q1d",
    "paop_flops_per_elem",
    "dense_flops_per_elem",
    "dense_gemm_flops_per_elem",
]


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


def dense_flops_per_elem(p: int, q1d: int | None = None) -> float:
    """Dense G3D contraction cost (the MFEM v4.8 baseline's O((p+1)^6))."""
    D = p + 1
    Q = default_q1d(p) if q1d is None else q1d
    return float(2 * 2 * (3 * D**3) * (3 * 3 * Q**3))


def dense_gemm_flops_per_elem(p: int, q1d: int | None = None) -> float:
    """FLOPs the two dense contractions of ``pa_baseline_apply`` execute
    (forward ``mqL,ecL->ecmq`` and backward ``ecmq,mqL->ecL``, 9 Q^3 D^3
    multiply-adds each): 36 Q^3 D^3, a third of
    :func:`dense_flops_per_elem`, whose model counts a dense 9Q^3 x 3D^3
    matrix.  The throughput rows keep the reference's model; this count
    places the same measurement by what the card runs."""
    D = p + 1
    Q = default_q1d(p) if q1d is None else q1d
    return float(2 * 2 * 9 * Q**3 * D**3)
