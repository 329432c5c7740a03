"""Matrix-free operator diagonal (MFEM AssembleDiagonal analog).

The (c, node)-diagonal of the element matrix is

    diag_e[c, ijk] = sum_{m,n} Chat[c,m,c,n](e,q) *
                     U^mn_x(qx,i) U^mn_y(qy,j) U^mn_z(qz,k)   summed over q

with U^mn_d = T^m_d . T^n_d elementwise products of the 1D tables
(T^m_d = G if d == m else B).  Chat is the pulled-back isotropic tensor
    Chat[c,m,c,n] = lam_w Jinv[m,c] Jinv[n,c]
                  + mu_w ((Jinv Jinv^T)[m,n] + Jinv[m,c] Jinv[n,c]).
Evaluated once at setup with ``torch.einsum``.
"""

from __future__ import annotations

import torch

__all__ = ["element_diagonal"]


def element_diagonal(lam_w, mu_w, jinv, B, G):
    """Per-element diagonal, shape (nelem, 3, D1D, D1D, D1D).

    lam_w / mu_w: (nelem, Q1D, Q1D, Q1D); jinv: (3, 3) (affine, shared) or
    (nelem, 3, 3).
    """
    per_elem_j = jinv.ndim == 3
    jjt = (
        torch.einsum("emj,enj->emn", jinv, jinv)
        if per_elem_j
        else jinv @ jinv.T
    )

    tables = (G, B)  # index by (d == m)

    def u_table(axis, m, n):
        tm = tables[0] if axis == m else tables[1]
        tn = tables[0] if axis == n else tables[1]
        return tm * tn  # (Q1D, D1D) elementwise

    out = 0.0
    for m in range(3):
        for n in range(3):
            ux = u_table(0, m, n)
            uy = u_table(1, m, n)
            uz = u_table(2, m, n)
            s_lam = torch.einsum("ezyx,zc,yb,xa->ecba", lam_w, uz, uy, ux)
            s_mu = torch.einsum("ezyx,zc,yb,xa->ecba", mu_w, uz, uy, ux)
            if per_elem_j:
                coef_c = jinv[:, m, :] * jinv[:, n, :]  # (ne, 3)
                out = out + coef_c[:, :, None, None, None] * (
                    s_lam[:, None] + s_mu[:, None]
                )
                out = out + jjt[:, m, n][:, None, None, None, None] * s_mu[:, None]
            else:
                coef_c = jinv[m] * jinv[n]  # (3,)
                out = out + coef_c[None, :, None, None, None] * (
                    s_lam[:, None] + s_mu[:, None]
                )
                out = out + jjt[m, n] * s_mu[:, None]
    return out
