"""Voigt notation utilities (paper Sec. 4.3).

Zero-based buffer order [00, 11, 22, 01, 02, 12].  The constitutive
relation is evaluated with the structured arithmetic of Sec. 4.5 — never
as a dense 6x6 matvec.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["VOIGT_INDEX", "stress_voigt"]

# (i, j) tensor indices -> voigt slot (symmetric)
VOIGT_INDEX = np.array([[0, 3, 4], [3, 1, 5], [4, 5, 2]])


def stress_voigt(grad, lam_w, mu_w):
    """Structured Voigt stress arithmetic (paper Sec. 4.5).

    ``grad[..., c, j]`` is the (weight-free) physical displacement gradient
    d_j u_c; ``lam_w``/``mu_w`` carry w_q * det(J) * {lambda, mu}.  Returns
    the 6 weighted Voigt components stacked on the last axis.
    """
    div = grad[..., 0, 0] + grad[..., 1, 1] + grad[..., 2, 2]
    ld = lam_w * div
    s00 = ld + 2.0 * mu_w * grad[..., 0, 0]
    s11 = ld + 2.0 * mu_w * grad[..., 1, 1]
    s22 = ld + 2.0 * mu_w * grad[..., 2, 2]
    s01 = mu_w * (grad[..., 0, 1] + grad[..., 1, 0])
    s02 = mu_w * (grad[..., 0, 2] + grad[..., 2, 0])
    s12 = mu_w * (grad[..., 1, 2] + grad[..., 2, 1])
    return torch.stack([s00, s11, s22, s01, s02, s12], dim=-1)
