"""Chebyshev-accelerated Jacobi smoother (MFEM OperatorChebyshevSmoother
analog; paper Sec. 3.1).

Requires only the operator action and its diagonal.  lambda_max of
D^{-1} A is estimated with a fixed number of power iterations (paper: 10)
at setup; the polynomial acts on the interval
[eig_lo_frac * hi, eig_hi_frac * lambda_max] (0.3 / 1.1).  Degree k = 2
by default, one pre- and one post-smoothing per V(1,1) cycle.

The power iteration's start vector is explicit: the caller passes one,
or it is drawn from a ``torch.Generator`` seeded with ``seed``.  (The
reference draws from ``jax.random.PRNGKey(1234)``, which torch cannot
reproduce; parity tests pass the reference's vector in.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["ChebyshevSmoother", "power_iteration_lmax", "start_vector"]


def start_vector(shape, dtype, device, seed: int = 1234) -> torch.Tensor:
    """Standard-normal start vector from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def power_iteration_lmax(A: Callable, dinv, v0: torch.Tensor, iters: int = 10):
    """Estimate lambda_max(D^{-1} A) with ``iters`` power iterations from
    the start vector ``v0``; returns a 0-dim tensor."""
    v = v0
    lam = torch.zeros((), dtype=v0.dtype, device=v0.device)
    for _ in range(iters):
        v = v / torch.sqrt(torch.sum(v * v))
        w = dinv * A(v)
        lam = torch.sum(v * w)
        v = w
    return torch.abs(lam)


@dataclasses.dataclass
class ChebyshevSmoother:
    """x <- x + p_k(D^{-1} A) D^{-1} (b - A x), Chebyshev on [lo, hi]."""

    A: Callable
    dinv: torch.Tensor
    lmax: torch.Tensor  # 0-dim
    degree: int = 2
    eig_lo_frac: float = 0.3
    eig_hi_frac: float = 1.1

    @classmethod
    def setup(cls, A, diagonal, *, degree=2, power_iters=10, v0=None, seed=1234):
        """``v0`` is the power iteration's start vector (shape and dtype of
        ``diagonal``); without one it is drawn from ``seed``."""
        # Essential-BC rows carry an identity diagonal by construction
        # (ConstrainedOperator.diagonal), but a zero slipping through
        # must not poison dinv with inf.
        safe = torch.where(diagonal == 0, 1.0, diagonal)
        dinv = 1.0 / safe
        if v0 is None:
            v0 = start_vector(diagonal.shape, diagonal.dtype, diagonal.device, seed)
        elif v0.shape != diagonal.shape:
            raise ValueError(
                f"start vector shape {tuple(v0.shape)} != {tuple(diagonal.shape)}"
            )
        lmax = power_iteration_lmax(
            A, dinv, v0.to(dtype=diagonal.dtype, device=diagonal.device), power_iters
        )
        return cls(A=A, dinv=dinv, lmax=lmax, degree=degree)

    def __call__(self, b, x=None):
        """Apply ``degree`` Chebyshev-Jacobi steps to A x = b."""
        # Coefficients live in the vector-block dtype, not lmax's.
        hi = self.eig_hi_frac * self.lmax.to(b.dtype)
        lo = self.eig_lo_frac * hi
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta

        if x is None:
            x = torch.zeros_like(b)
            r = b
        else:
            r = b - self.A(x)
        z = self.dinv * r
        d = z / theta
        rho = 1.0 / sigma
        for _ in range(self.degree):
            x = x + d
            r = r - self.A(d)
            z = self.dinv * r
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            rho = rho_new
        return x
