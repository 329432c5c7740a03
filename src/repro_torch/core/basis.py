"""1D basis and quadrature tables for tensor-product elements.

The paper (Sec. 4.4) uses D1D = p+1 Gauss-Lobatto-Legendre (GLL) nodal
points for the degree-p Lagrange basis and Q1D = p+2 Gauss-Legendre
quadrature points (MFEM's default over-integration rule).  The 1D
interpolation table ``B[q, i] = phi_i(xi_q)`` and derivative table
``G[q, i] = phi_i'(xi_q)`` are the quadrature-sampled matrix
representations of the one-dimensional operators B_1D / G_1D; everything
in the sum-factorized operator is built from them.

Tables are computed in float64 numpy (setup-time, never traced) and cast
to the operator dtype at use sites.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "gll_nodes",
    "gauss_points",
    "lagrange_tables",
    "BasisTables",
    "basis_tables",
]


def gll_nodes(p: int) -> np.ndarray:
    """Gauss-Lobatto-Legendre nodes on [-1, 1] for degree ``p`` (p+1 points).

    Interior nodes are the roots of P'_p (derivative of the Legendre
    polynomial), found via the eigenvalues of the Jacobi matrix of the
    (1,1)-Jacobi polynomials; endpoints are +-1.
    """
    if p < 1:
        raise ValueError(f"degree must be >= 1, got {p}")
    if p == 1:
        return np.array([-1.0, 1.0])
    # Roots of P'_p == roots of Jacobi polynomial P^{(1,1)}_{p-1}.
    # Golub-Welsch on the Jacobi(1,1) recurrence.
    n = p - 1
    k = np.arange(1, n)
    # Jacobi(1,1) three-term recurrence off-diagonal terms.
    b = np.sqrt(k * (k + 2) / ((2 * k + 1) * (2 * k + 3)))
    J = np.diag(b, 1) + np.diag(b, -1)
    interior = np.sort(np.linalg.eigvalsh(J))
    nodes = np.concatenate([[-1.0], interior, [1.0]])
    # Polish with a couple of Newton steps on (1-x^2) P'_p(x).
    for _ in range(2):
        Pp, dPp = _legendre_deriv(p, nodes[1:-1])
        f = dPp  # roots of P'_p
        # d/dx P'_p = P''_p ; from Legendre ODE: (1-x^2) P'' = 2x P' - p(p+1) P
        x = nodes[1:-1]
        d2 = (2 * x * dPp - p * (p + 1) * Pp) / (1 - x * x)
        nodes[1:-1] = x - f / d2
    return nodes


def _legendre_deriv(p: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (P_p(x), P'_p(x)) via the stable three-term recurrence."""
    P0 = np.ones_like(x)
    P1 = x.copy()
    if p == 0:
        return P0, np.zeros_like(x)
    for k in range(2, p + 1):
        P0, P1 = P1, ((2 * k - 1) * x * P1 - (k - 1) * P0) / k
    # derivative identity: (1-x^2) P'_p = p (P_{p-1} - x P_p)
    dP = p * (P0 - x * P1) / (1 - x * x)
    return P1, dP


def gauss_points(q: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points and weights on [-1, 1]."""
    pts, wts = np.polynomial.legendre.leggauss(q)
    return pts, wts


def lagrange_tables(nodes: np.ndarray, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values/derivatives of the Lagrange basis on ``nodes`` at ``pts``.

    Returns ``B[q, i] = phi_i(pts[q])`` and ``G[q, i] = phi_i'(pts[q])``
    using barycentric formulas (stable for GLL nodes up to high degree).
    """
    n = len(nodes)
    # Barycentric weights.
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    w = 1.0 / np.prod(diff, axis=1)

    B = np.empty((len(pts), n))
    G = np.empty((len(pts), n))
    for q, x in enumerate(pts):
        d = x - nodes
        if np.any(d == 0.0):
            # Evaluation point coincides with a node (GLL-collocated rules).
            i0 = int(np.argmin(np.abs(d)))
            B[q] = 0.0
            B[q, i0] = 1.0
            # Derivative at node i0: differentiation-matrix row
            #   D[i0, j] = (w_j / w_i0) / (x_i0 - x_j),  D[i0, i0] = -sum_j.
            row = np.zeros(n)
            mask = np.arange(n) != i0
            row[mask] = (w[mask] / w[i0]) / (nodes[i0] - nodes[mask])
            row[i0] = -np.sum(row[mask])
            G[q] = row
            continue
        # Barycentric: with t_j = w_j/(x - x_j), s = sum t:  phi_i = t_i/s and
        # phi_i' = phi_i * (sum_j t_j/d_j / s  -  1/d_i).
        t = w / d
        s = np.sum(t)
        B[q] = t / s
        s2 = np.sum(t / d)
        G[q] = B[q] * (s2 / s - 1.0 / d)
    return B, G


class BasisTables:
    """Container for the 1D tables of a (p, q) tensor-product element."""

    __slots__ = ("p", "d1d", "q1d", "nodes", "qpts", "qwts", "B", "G")

    def __init__(self, p: int, q1d: int | None = None):
        self.p = p
        self.d1d = p + 1
        self.q1d = q1d if q1d is not None else p + 2  # MFEM over-integration
        self.nodes = gll_nodes(p)
        self.qpts, self.qwts = gauss_points(self.q1d)
        self.B, self.G = lagrange_tables(self.nodes, self.qpts)

    def __repr__(self) -> str:  # pragma: no cover
        return f"BasisTables(p={self.p}, D1D={self.d1d}, Q1D={self.q1d})"


@functools.lru_cache(maxsize=None)
def basis_tables(p: int, q1d: int | None = None) -> BasisTables:
    return BasisTables(p, q1d)
