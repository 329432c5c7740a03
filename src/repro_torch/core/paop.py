"""PAop: the fully fused, sum-factorized, Voigt-form element operator
(paper Sec. 4.2-4.5), as plain PyTorch over a batch of elements.

Interpolate the gradient, evaluate the six-component weighted Voigt
stress pointwise, pull the rows back to reference directions, and apply
the transpose contractions.  This is the plain version of the CUDA
kernel in :mod:`repro_torch.kernels.pa_elasticity`: the CPU runs it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.contract import backward_grad_t, forward_grad
from repro_torch.core.voigt import VOIGT_INDEX, stress_voigt

__all__ = ["paop_apply"]


def paop_apply(x_e, lam_w, mu_w, jinv, B, G):
    """Fused PAop action over a batch of elements.

    x_e:   (nelem, 3, D1D, D1D, D1D)   element displacement (e, c, iz, iy, ix)
    lam_w: (nelem, Q1D, Q1D, Q1D)      w det(J) lambda at qpoints (mu_w likewise)
    jinv:  (3, 3) mesh-constant, or (nelem, 3, 3) per element
    """
    grad_ref = forward_grad(x_e, B, G)  # (e, c, m, qz, qy, qx)
    # Physical gradient d_j u_c = sum_m ghat[c, m] Jinv[m, j].
    if jinv.ndim == 2:
        grad = torch.einsum("ecmzyx,mj->ezyxcj", grad_ref, jinv)
    else:
        grad = torch.einsum("ecmzyx,emj->ezyxcj", grad_ref, jinv)
    sv = stress_voigt(grad, lam_w, mu_w)  # (e, qz, qy, qx, 6)
    # Rows of sigma from the symmetric Voigt buffer, pulled back by J^{-T}.
    rows = sv[..., torch.as_tensor(VOIGT_INDEX, device=sv.device)]
    if jinv.ndim == 2:
        q = torch.einsum("ezyxcj,mj->ecmzyx", rows, jinv)
    else:
        q = torch.einsum("ezyxcj,emj->ecmzyx", rows, jinv)
    return backward_grad_t(q, B, G)
