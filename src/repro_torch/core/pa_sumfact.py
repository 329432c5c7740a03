"""Ablation stages C1 / C2: sum-factorized but *unfused* PA operators.

C1 (paper Sec. 4.4): replaces the dense O((p+1)^6) contraction of the
baseline by three 1D contraction sweeps per direction — but, like the
pre-fusion MFEM layout, it remains organized as whole-mesh passes whose
full-volume intermediates (reference gradients, the 3x3 stress ``QVec``)
are materialized between kernels.

C2 (paper Sec. 4.3): C1 + Voigt notation — the whole-mesh stress
intermediate shrinks from 9 to 6 components and the constitutive update
uses the structured arithmetic.  The paper observes (Table 7) that its
marginal benefit is small until fusion removes the round trip; keeping
the stage separate lets the ablation reproduce that.
"""

from __future__ import annotations

import torch

from repro_torch.core.contract import backward_grad_t, forward_grad
from repro_torch.core.voigt import VOIGT_INDEX, stress_voigt

__all__ = ["pa_sumfact_apply", "pa_sumfact_voigt_apply"]


def _phys_grad(grad_ref, jinv):
    """(ne, 3c, 3m, qz, qy, qx) reference -> physical: d_j u_c."""
    if jinv.ndim == 2:
        return torch.einsum("ecmzyx,mj->ecjzyx", grad_ref, jinv)
    return torch.einsum("ecmzyx,emj->ecjzyx", grad_ref, jinv)


def _pullback(sigma_rows, jinv):
    """Q[c, m] = sum_j sigma[c, j] Jinv[m, j]."""
    if jinv.ndim == 2:
        return torch.einsum("ecjzyx,mj->ecmzyx", sigma_rows, jinv)
    return torch.einsum("ecjzyx,emj->ecmzyx", sigma_rows, jinv)


def pa_sumfact_apply(x_e, lam_w, mu_w, jinv, B, G):
    """C1: sum-factorized sweeps, full 3x3 stress intermediate."""
    grad = _phys_grad(forward_grad(x_e, B, G), jinv)  # (ne, c, j, z, y, x)

    div = grad[:, 0, 0] + grad[:, 1, 1] + grad[:, 2, 2]
    eye = torch.eye(3, dtype=x_e.dtype, device=x_e.device)
    sym = grad + grad.transpose(1, 2)
    del grad
    lw = lam_w[:, None, None]
    mw = mu_w[:, None, None]
    sigma = lw * div[:, None, None] * eye[None, :, :, None, None, None] + mw * sym
    del sym, div

    return backward_grad_t(_pullback(sigma, jinv), B, G)


def pa_sumfact_voigt_apply(x_e, lam_w, mu_w, jinv, B, G):
    """C2: C1 + six-component Voigt stress with structured arithmetic."""
    grad = _phys_grad(forward_grad(x_e, B, G), jinv)  # (ne, c, j, z, y, x)

    # stress_voigt wants (..., c, j) trailing: move the small axes last.
    g = torch.movedim(grad, (1, 2), (-2, -1))  # (ne, z, y, x, c, j)
    sv = stress_voigt(g, lam_w, mu_w)  # (ne, z, y, x, 6)
    del grad, g
    sigma = torch.movedim(_voigt_rows(sv), (-2, -1), (1, 2))  # (ne, c, j, z, y, x)
    del sv

    return backward_grad_t(_pullback(sigma, jinv), B, G)


def _voigt_rows(sv):
    """Reconstruct sigma rows (..., c, j) from Voigt components (..., 6)
    via the symmetric index map (sigma_10 reads the same cell as sigma_01)."""
    rows = [
        torch.stack([sv[..., int(VOIGT_INDEX[c, j])] for j in range(3)], dim=-1)
        for c in range(3)
    ]
    return torch.stack(rows, dim=-2)
