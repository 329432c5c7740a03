"""Coarsest-level solver for the GMG hierarchy (paper Sec. 3.2).

The paper assembles only the coarsest-level matrix and solves it with an
inexact inner PCG.  Two solvers:

* ``cholesky``: a prefactorized dense Cholesky solve.  The dense matrix
  comes from probing the constrained coarse operator with identity
  columns, for every material form (the reference assembles dict
  materials through scipy instead; the two agree to round-off).  A
  scenario-batched operator gets one factor per scenario;
* ``pcg_jacobi``: the paper's inexact inner PCG with a Jacobi
  preconditioner (single scenario only).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.operators import ElasticityOperator
from repro_torch.solvers.cg import pcg

__all__ = ["make_coarse_solver", "probe_coarse_matrix", "cholesky_solver"]


def probe_coarse_matrix(op: ElasticityOperator) -> torch.Tensor:
    """Densify the constrained operator by applying it to the identity
    columns: the (n, n) matrix, n = nscalar * 3, or the (S, n, n) stack of
    a scenario-batched operator.

    All n columns go through ONE apply: they are folded into the scenario
    axis (n * S rows, each scenario's weighted fields repeated n times).
    Elements are independent and the scatter sums in a fixed order, so
    each column is what its own apply would give."""
    nscalar, ne = op.space.nscalar, op.space.nelem
    n, s = nscalar * 3, op.nbatch or 1
    tail = op.lam_w.shape[1:]

    def repeat(w):
        w = w.reshape((1, s * ne) + tail).expand((n, s * ne) + tail)
        return w.reshape((n * s * ne,) + tail)

    cols = op.with_material_weights(repeat(op.lam_w), repeat(op.mu_w), n * s)
    eye = torch.eye(n, dtype=op.dtype, device=op.device).reshape(n, 1, nscalar, 3)
    y = cols.constrained()(eye.expand(n, s, nscalar, 3).reshape(n * s, nscalar, 3))
    K = y.reshape(n, s, n).permute(1, 2, 0)  # (scenario, i, column j)
    return K if op.nbatch is not None else K[0]


def cholesky_solver(L: torch.Tensor) -> Callable:
    """solve(b) from a lower Cholesky factor (n, n), or a per-scenario stack
    (S, n, n) for b of shape (S, nscalar, 3)."""

    def solve(b):
        return torch.cholesky_solve(b.reshape(L.shape[:-1] + (1,)), L).reshape(b.shape)

    return solve


def make_coarse_solver(
    op: ElasticityOperator,
    method: str = "cholesky",
    rel_tol: float = 1e-2,
    max_iter: int = 10,
) -> Callable:
    """Return solve(b) -> x for the constrained coarsest-level system."""
    if method == "cholesky":
        return cholesky_solver(torch.linalg.cholesky(probe_coarse_matrix(op)))

    if method == "pcg_jacobi":
        if op.nbatch is not None:
            raise NotImplementedError(
                "batched coarse solve supports only 'cholesky', got 'pcg_jacobi'"
            )
        cop = op.constrained()
        dinv = 1.0 / cop.diagonal()

        def solve(b):
            return pcg(
                cop, b, M=lambda r: dinv * r, rel_tol=rel_tol, maxiter=max_iter
            ).x

        return solve

    raise ValueError(f"unknown coarse solver {method!r}")
