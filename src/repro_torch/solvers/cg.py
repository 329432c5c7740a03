"""Preconditioned conjugate gradients with MFEM CGSolver semantics.

For preconditioned solves MFEM tests (B r_k, r_k)^{1/2} / (B r_0, r_0)^{1/2}
<= rel_tol (paper Sec. 3.2); iteration capped at ``maxiter``.  The loop is
a Python loop; its stopping test reads two flags from the device once per
iteration (one host sync per iteration).

``flexible=True`` takes the Polak-Ribiere direction update,
beta = (z_k, r_k - r_{k-1}) / (z_{k-1}, r_{k-1}), for a preconditioner that
is not a fixed linear map to working precision (a bfloat16 V-cycle: its
rounding changes with its input).  With a fixed SPD preconditioner the
extra term (z_k, r_{k-1}) is zero in exact arithmetic (Notay, "Flexible
conjugate gradients", SIAM J. Sci. Comput. 22, 2000).  Such a
preconditioner need not be positive definite either: a negative
(z_k, r_k) is a breakdown, which stops the loop unconverged (in the
fixed-preconditioner loop it would pass the stopping test).
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
    flexible: bool = False,
) -> PCGResult:
    """MFEM-style PCG. ``A`` and ``M`` map L-vectors to L-vectors;
    ``flexible`` as in the module docstring."""
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
        r_prev, r = r, r - alpha * ad
        z = M(r)
        betanom = _dot(z, r)
        num = betanom - _dot(z, r_prev) if flexible else betanom
        beta = num / torch.where(nom == 0, 1.0, nom)
        d = torch.where(bad, d, z + beta * d)
        if flexible:
            # A breakdown keeps the last (positive) nom: unconverged.
            bad = bad | (betanom < 0)
            betanom = torch.where(betanom < 0, nom, betanom)
        nom = betanom
        stop, above = torch.stack([bad, nom > threshold]).tolist()
        if not stop:
            k += 1
        going = above and not stop and k < maxiter
    return PCGResult(
        x=x,
        iterations=k,
        # (flexible: a negative nom can only be nom0, a breakdown)
        converged=bool(nom <= threshold) and not (flexible and bool(nom < 0)),
        final_norm=float(torch.sqrt(torch.abs(nom))),
        initial_norm=float(torch.sqrt(torch.abs(nom0))),
    )
