"""Sum-factorized 1D tensor contractions (paper Sec. 4.4 / 4.5).

The forward sweep evaluates reference-space gradients at quadrature points
through three sequential 1D contractions (X, then Y, then Z); the backward
sweep is its exact transpose.  Trailing axes are the tensor-product axes
``(..., iz, iy, ix)``.  ``B[q, i] = phi_i(xi_q)``, ``G[q, i] = phi_i'(xi_q)``.
"""

from __future__ import annotations

import torch

__all__ = ["forward_grad", "backward_grad_t"]


def forward_grad(x, B, G):
    """Reference gradient at quadrature points.

    x: (..., D1D, D1D, D1D) laid out (iz, iy, ix).
    Returns (..., 3, Q1D, Q1D, Q1D) with axis -4 the reference direction
    (d_xi, d_eta, d_zeta) and trailing axes (qz, qy, qx).
    """
    u = torch.einsum("...zyx,qx->...zyq", x, B)
    v = torch.einsum("...zyx,qx->...zyq", x, G)
    d_xi = torch.einsum("...zyq,ry->...zrq", v, B)
    d_eta = torch.einsum("...zyq,ry->...zrq", u, G)
    u_xy = torch.einsum("...zyq,ry->...zrq", u, B)
    g_xi = torch.einsum("...zrq,sz->...srq", d_xi, B)
    g_eta = torch.einsum("...zrq,sz->...srq", d_eta, B)
    g_zeta = torch.einsum("...zrq,sz->...srq", u_xy, G)
    return torch.stack([g_xi, g_eta, g_zeta], dim=-4)


def backward_grad_t(q, B, G):
    """Transpose of :func:`forward_grad` (the test-function contraction).

    q: (..., 3, Q1D, Q1D, Q1D).  Returns (..., D1D, D1D, D1D): G along
    direction m, B along the other two, summed over the three m-channels.
    """

    def sweep(t, tx, ty, tz):
        t = torch.einsum("...srq,sz->...zrq", t, tz)
        t = torch.einsum("...zrq,ry->...zyq", t, ty)
        return torch.einsum("...zyq,qx->...zyx", t, tx)

    return (
        sweep(q[..., 0, :, :, :], G, B, B)
        + sweep(q[..., 1, :, :, :], B, G, B)
        + sweep(q[..., 2, :, :, :], B, B, G)
    )
