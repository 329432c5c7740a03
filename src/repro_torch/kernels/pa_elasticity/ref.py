"""Plain PyTorch version of the PAop kernel.

Same math as :mod:`repro_torch.core.paop`, re-exposed in the kernel's
calling convention: the wrapper runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.

bfloat16 x_e, lam_w and mu_w (with float32 tables, as the kernel takes
them) are computed as the kernel's bfloat16 instantiation computes them:
upcast to float32, the float32 apply, y rounded to bfloat16 once.  (The
reference takes bfloat16 tables and rounds every contraction to
bfloat16.)
"""

from __future__ import annotations

import torch

from repro_torch.core.paop import paop_apply

__all__ = ["paop_ref", "probe_ref"]


def paop_ref(x_e, lam_w, mu_w, jinv, B, G):
    """x_e: (nelem, 3, D1D, D1D, D1D) element-first framework layout."""
    if x_e.dtype == torch.bfloat16:
        up = (t.float() for t in (x_e, lam_w, mu_w))
        return paop_apply(*up, jinv, B, G).to(torch.bfloat16)
    return paop_apply(x_e, lam_w, mu_w, jinv, B, G)


def probe_ref(x):
    """Plain version of the probe kernel."""
    return 2.0 * x
