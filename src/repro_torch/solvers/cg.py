"""Preconditioned conjugate gradients with MFEM CGSolver semantics.

For preconditioned solves MFEM tests (B r_k, r_k)^{1/2} / (B r_0, r_0)^{1/2}
<= rel_tol (paper Sec. 3.2); iteration capped at ``maxiter``.  The loop is
a Python loop; its stopping test reads two flags from the device once per
iteration (one host sync per iteration).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["pcg", "PCGResult"]


@dataclasses.dataclass
class PCGResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    final_norm: float  # sqrt((B r, r)) at exit
    initial_norm: float


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def pcg(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    *,
    x0=None,
    rel_tol: float = 1e-6,
    abs_tol: float = 0.0,
    maxiter: int = 5000,
) -> PCGResult:
    """MFEM-style PCG. ``A`` and ``M`` map L-vectors to L-vectors."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0

    r = b - A(x)
    z = M(r)
    nom0 = _dot(z, r)
    # MFEM: r0 = max(nom0 * rel_tol^2, abs_tol^2).  A zero RHS (or an x0
    # that already solves the system) gives nom0 == 0 <= threshold, so the
    # loop never runs and the solve reports converged immediately.
    threshold = torch.clamp(nom0 * rel_tol ** 2, min=abs_tol ** 2)
    d, nom, k = z, nom0, 0
    going = bool(nom > threshold) and maxiter > 0
    while going:
        ad = A(d)
        den = _dot(d, ad)
        # den <= 0 means a degenerate direction (non-SPD input, or an
        # exactly-converged state): take no step and stop, mirroring
        # MFEM's "PCG: The operator is not positive definite" break.
        bad = den <= 0
        alpha = torch.where(bad, 0.0, nom / torch.where(bad, 1.0, den))
        x = x + alpha * d
        r = r - alpha * ad
        z = M(r)
        betanom = _dot(z, r)
        beta = betanom / torch.where(nom == 0, 1.0, nom)
        d = torch.where(bad, d, z + beta * d)
        nom = betanom
        stop, above = torch.stack([bad, nom > threshold]).tolist()
        if not stop:
            k += 1
        going = above and not stop and k < maxiter
    return PCGResult(
        x=x,
        iterations=k,
        converged=bool(nom <= threshold),
        final_norm=float(torch.sqrt(torch.abs(nom))),
        initial_norm=float(torch.sqrt(torch.abs(nom0))),
    )
