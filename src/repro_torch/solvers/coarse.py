"""Coarsest-level solver for the GMG hierarchy (paper Sec. 3.2).

The paper assembles only the coarsest-level matrix and solves it with an
inexact inner PCG.  Two solvers:

* ``cholesky``: a prefactorized dense Cholesky solve.  The dense matrix
  comes from probing the constrained coarse operator with identity
  columns, for every material form (the reference assembles dict
  materials through scipy instead; the two agree to round-off);
* ``pcg_jacobi``: the paper's inexact inner PCG with a Jacobi
  preconditioner.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.operators import ElasticityOperator
from repro_torch.solvers.cg import pcg

__all__ = ["make_coarse_solver", "probe_coarse_matrix"]


def probe_coarse_matrix(cop, nscalar: int, dtype, device) -> torch.Tensor:
    """Densify a constrained operator by applying it to the identity
    columns: returns the (n, n) matrix, n = nscalar * 3."""
    n = nscalar * 3
    eye = torch.eye(n, dtype=dtype, device=device)
    cols = [cop(eye[j].reshape(nscalar, 3)).reshape(n) for j in range(n)]
    return torch.stack(cols, dim=1)


def make_coarse_solver(
    op: ElasticityOperator,
    method: str = "cholesky",
    rel_tol: float = 1e-2,
    max_iter: int = 10,
) -> Callable:
    """Return solve(b) -> x for the constrained coarsest-level system."""
    cop = op.constrained()
    if method == "cholesky":
        K = probe_coarse_matrix(cop, op.space.nscalar, op.dtype, op.device)
        L = torch.linalg.cholesky(K)

        def solve(b):
            return torch.cholesky_solve(b.reshape(-1, 1), L).reshape(b.shape)

        return solve

    if method == "pcg_jacobi":
        dinv = 1.0 / cop.diagonal()

        def solve(b):
            return pcg(
                cop, b, M=lambda r: dinv * r, rel_tol=rel_tol, maxiter=max_iter
            ).x

        return solve

    raise ValueError(f"unknown coarse solver {method!r}")
