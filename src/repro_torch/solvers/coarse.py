"""Coarsest-level solver for the GMG hierarchy (paper Sec. 3.2).

The paper assembles only the coarsest-level matrix and solves it with an
inexact inner PCG.  Two solvers:

* ``cholesky``: a prefactorized dense Cholesky solve.  For one scenario
  whose materials are an attribute dict, the dense matrix is the
  assembled one (:func:`repro_torch.core.fa.assemble_csr` with the
  essential rows and columns eliminated), as in the reference; for
  per-element fields and scenario batches it comes from probing the
  constrained coarse operator with identity columns (the two agree to
  round-off).  A scenario-batched operator gets one factor per scenario;
* ``pcg_jacobi``: the paper's inexact inner PCG with a Jacobi
  preconditioner (single scenario only).

The Cholesky factor of a bfloat16 operator (the ``mixed-bf16`` V-cycle)
is formed and factored in float32 (:func:`factor_dtype`): bfloat16 has
too few mantissa bits to factor even a well-conditioned coarse matrix,
and torch has no bfloat16 Cholesky.  The solve enters and leaves it with
casts.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.fa import assemble_csr
from repro_torch.core.geometry import quadrature_geometry
from repro_torch.core.operators import ElasticityOperator
from repro_torch.solvers.cg import pcg

__all__ = [
    "factor_dtype",
    "make_coarse_solver",
    "assembled_coarse_matrix",
    "probe_coarse_matrix",
    "cholesky_solver",
]


def factor_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the coarse matrix of an operator in ``dtype`` is formed and
    factored in: ``dtype`` itself, float32 for bfloat16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def assembled_coarse_matrix(op: ElasticityOperator) -> torch.Tensor:
    """The constrained (n, n) matrix of a single-scenario operator with
    attribute-dict materials, assembled through scipy (essential rows and
    columns eliminated, unit diagonal), as a dense tensor on the
    operator's device at :func:`factor_dtype` of its dtype."""
    space = op.space
    csr = assemble_csr(
        space,
        quadrature_geometry(space.mesh, space.tables),
        op.materials,
        ess_mask=op.ess_mask.cpu().numpy(),
    )
    return torch.as_tensor(csr.toarray(), dtype=factor_dtype(op.dtype), device=op.device)


def probe_coarse_matrix(op: ElasticityOperator) -> torch.Tensor:
    """Densify the constrained operator by applying it to the identity
    columns: the (n, n) matrix, n = nscalar * 3, or the (S, n, n) stack of
    a scenario-batched operator, in the operator's dtype (a bfloat16
    operator is probed through its :meth:`~ElasticityOperator.with_dtype`
    float32 copy: :func:`make_coarse_solver`).

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
        cdt = factor_dtype(op.dtype)
        if op.nbatch is None and isinstance(op.materials, dict):
            K = assembled_coarse_matrix(op)
        else:
            K = probe_coarse_matrix(op if cdt == op.dtype else op.with_dtype(cdt))
        solve = cholesky_solver(torch.linalg.cholesky(K))
        if cdt == op.dtype:
            return solve
        return lambda b: solve(b.to(cdt)).to(op.dtype)

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
