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

Scenario batching: with ``batch_dims=1`` the operator, diagonal and
vectors carry a leading scenario axis (S, ...).  The start vector has
the per-scenario shape and is broadcast, lambda_max is estimated per
scenario (an (S,) tensor), and the Chebyshev coefficients broadcast over
each scenario's vector block.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["ChebyshevSmoother", "power_iteration_lmax", "start_vector"]


def _expand(a, ndim: int):
    """Right-pad ``a`` with singleton axes so it broadcasts against an
    ndim-dimensional vector block ((S,) coefficients vs (S, n, 3))."""
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def start_vector(shape, dtype, device, seed: int = 1234) -> torch.Tensor:
    """Standard-normal start vector from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def power_iteration_lmax(
    A: Callable, dinv, v0: torch.Tensor, iters: int = 10, batch_dims: int = 0
):
    """Estimate lambda_max(D^{-1} A) with ``iters`` power iterations from
    the start vector ``v0``, of shape ``dinv.shape[batch_dims:]`` and
    broadcast over the leading ``batch_dims`` axes.  Norms and Rayleigh
    quotients are taken per scenario; returns a tensor of shape
    ``dinv.shape[:batch_dims]``."""
    v = v0.expand(dinv.shape)
    axes = tuple(range(batch_dims, v.ndim))
    lam = torch.zeros(dinv.shape[:batch_dims], dtype=v0.dtype, device=v0.device)
    for _ in range(iters):
        v = v / _expand(torch.sqrt(torch.sum(v * v, dim=axes)), v.ndim)
        w = dinv * A(v)
        lam = torch.sum(v * w, dim=axes)
        v = w
    return torch.abs(lam)


@dataclasses.dataclass
class ChebyshevSmoother:
    """x <- x + p_k(D^{-1} A) D^{-1} (b - A x), Chebyshev on [lo, hi]."""

    A: Callable
    dinv: torch.Tensor
    lmax: torch.Tensor  # 0-dim, or (S,) for a scenario batch
    degree: int = 2
    eig_lo_frac: float = 0.3
    eig_hi_frac: float = 1.1

    @classmethod
    def setup(
        cls, A, diagonal, *, degree=2, power_iters=10, v0=None, seed=1234, batch_dims=0
    ):
        """``v0`` is the power iteration's start vector, of the dtype of
        ``diagonal`` and its shape without the ``batch_dims`` leading
        (scenario) axes; without one it is drawn from ``seed``."""
        # Essential-BC rows carry an identity diagonal by construction
        # (ConstrainedOperator.diagonal), but a zero slipping through
        # must not poison dinv with inf.
        safe = torch.where(diagonal == 0, 1.0, diagonal)
        dinv = 1.0 / safe
        shape = diagonal.shape[batch_dims:]
        if v0 is None:
            v0 = start_vector(shape, diagonal.dtype, diagonal.device, seed)
        elif v0.shape != shape:
            raise ValueError(
                f"start vector shape {tuple(v0.shape)} != {tuple(shape)}"
            )
        lmax = power_iteration_lmax(
            A, dinv, v0.to(dtype=diagonal.dtype, device=diagonal.device), power_iters,
            batch_dims,
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
        d = z / _expand(theta, b.ndim)
        rho = 1.0 / sigma
        for _ in range(self.degree):
            x = x + d
            r = r - self.A(d)
            z = self.dinv * r
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = _expand(rho_new * rho, b.ndim) * d + (
                2.0 * _expand(rho_new, b.ndim) / _expand(delta, b.ndim)
            ) * z
            rho = rho_new
        return x
