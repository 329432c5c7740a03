"""MFEM v4.8 baseline linear-elasticity PA dataflow (paper Algorithm 1).

The two-kernel baseline, as plain PyTorch over a batch of elements:

* Kernel 1 computes the geometrically transformed, weighted stress at all
  quadrature points of all elements and writes it to the operator-wide
  ``QVec`` array (a real whole-mesh intermediate — the memory round trip
  the paper identifies as the first bottleneck).
* Kernel 2 re-reads ``QVec`` in full and contracts it against the dense 3D
  basis-gradient table ``G3D`` of size (3, Q1D^3, D1D^3) — the
  O((p+1)^6)-per-element contraction that keeps the baseline's
  operator-throughput sweet spot near p ~= 2.

Both the forward interpolation and the backward action use the dense table
(no sum factorization).  On the card the two dense contractions are
GEMMs (cuBLAS); everything between them is whole-mesh elementwise passes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.basis import BasisTables

__all__ = ["dense_grad_table", "pa_baseline_apply"]


@functools.lru_cache(maxsize=None)
def _dense_grad_table_np(p: int, q1d: int | None = None) -> np.ndarray:
    tb = BasisTables(p, q1d)
    B, G = tb.B, tb.G

    # G3[m, (qz,qy,qx), (kz,ky,kx)] = prod of B/G with G along direction m.
    def outer3(tz, ty, tx):
        t = np.einsum("sc,rb,qa->srqcba", tz, ty, tx)
        n_q, n_d = tb.q1d ** 3, tb.d1d ** 3
        return t.reshape(n_q, n_d)

    g3 = np.stack([outer3(B, B, G), outer3(B, G, B), outer3(G, B, B)])
    return g3  # (3, nq, nd), float64


def dense_grad_table(
    p: int, q1d: int | None = None, dtype: torch.dtype = torch.float64, device=None
) -> torch.Tensor:
    """Dense 3D reference-gradient basis table (3, Q1D^3, D1D^3)."""
    return torch.as_tensor(_dense_grad_table_np(p, q1d), dtype=dtype, device=device)


def pa_baseline_apply(x_e, lam_w, mu_w, jinv, g3d):
    """Algorithm 1: y_e = A_e x_e with the dense-contraction dataflow.

    x_e:    (nelem, 3, D1D, D1D, D1D) element-local displacement
    lam_w:  (nelem, Q1D, Q1D, Q1D) = w det(J) lambda  (mu_w likewise)
    jinv:   (3, 3) or (nelem, 3, 3) per-element-constant J^{-1}
    g3d:    (3, Q1D^3, D1D^3) dense reference-gradient table
    returns (nelem, 3, D1D, D1D, D1D)
    """
    ne = x_e.shape[0]
    nq, nd = g3d.shape[1], g3d.shape[2]
    xf = x_e.reshape(ne, 3, nd)

    # ---- PhysDerivatives: dense O(p^6) interpolation of the gradient.
    grad_ref = torch.einsum("mqL,ecL->ecmq", g3d, xf)  # (ne, 3, 3, nq)
    if jinv.ndim == 2:
        grad = torch.einsum("ecmq,mj->ecjq", grad_ref, jinv)
    else:
        grad = torch.einsum("ecmq,emj->ecjq", grad_ref, jinv)
    del grad_ref

    # ---- Kernel 1: stress at quadrature points -> operator-wide QVec.
    # sigma = lam_w div I + mu_w (grad + grad^T): the off-diagonal terms
    # are mu_w * 2 eps alone, so lam_w div is added on the diagonal only
    # (in place, one whole-mesh buffer fewer).
    ld = lam_w.reshape(ne, nq) * (grad[:, 0, 0] + grad[:, 1, 1] + grad[:, 2, 2])
    sigma = grad + grad.transpose(1, 2)  # 2 eps
    del grad
    sigma.mul_(mu_w.reshape(ne, 1, 1, nq))
    for i in range(3):
        sigma[:, i, i] += ld
    del ld
    # Pull back to reference test-directions: QVec[c, m] = sigma[c, j] Jinv[m, j].
    if jinv.ndim == 2:
        qvec = torch.einsum("ecjq,mj->ecmq", sigma, jinv)
    else:
        qvec = torch.einsum("ecjq,emj->ecmq", sigma, jinv)
    del sigma

    # ---- Kernel 2: dense O(p^6) operator action, streaming G3D again.
    y = torch.einsum("ecmq,mqL->ecL", qvec, g3d)
    return y.reshape(x_e.shape)
