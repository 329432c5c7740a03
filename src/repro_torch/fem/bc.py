"""Essential (Dirichlet) boundary-condition handling.

Mirrors MFEM's ``ConstrainedOperator`` semantics: given the unconstrained
operator action A and the set of essential DoFs E,

    y = A (x with x_E zeroed);   y_E = x_E

which keeps the constrained operator symmetric positive-definite with a
unit diagonal block on E.  RHS elimination for inhomogeneous data is
``b <- b - A x_bc`` followed by ``b_E <- x_bc_E``.
"""

from __future__ import annotations

import torch

__all__ = ["ConstrainedOperator", "eliminate_rhs"]


class ConstrainedOperator:
    """Wraps ``apply(x) -> y`` with MFEM ConstrainedOperator semantics.
    ``ess_mask`` is a bool tensor on the operator's device."""

    def __init__(self, apply_fn, ess_mask: torch.Tensor, diagonal_fn=None):
        self._apply = apply_fn
        self.ess_mask = ess_mask
        self._diagonal_fn = diagonal_fn

    def __call__(self, x):
        m = self.ess_mask
        y = self._apply(torch.where(m, 0.0, x))
        return torch.where(m, x, y)

    def diagonal(self):
        """Operator diagonal with ones on constrained DoFs (what MFEM's
        AssembleDiagonal + ConstrainedOperator produce for the smoother)."""
        if self._diagonal_fn is None:
            raise ValueError("no diagonal_fn provided")
        d = self._diagonal_fn()
        return torch.where(self.ess_mask, 1.0, d)


def eliminate_rhs(apply_fn, ess_mask: torch.Tensor, b, x_bc=None):
    """Form the reduced RHS for essential BCs (x_bc defaults to zero)."""
    if x_bc is None:
        return torch.where(ess_mask, 0.0, b)
    xb = torch.where(ess_mask, x_bc, 0.0)
    b2 = b - apply_fn(xb)
    return torch.where(ess_mask, xb, b2)
