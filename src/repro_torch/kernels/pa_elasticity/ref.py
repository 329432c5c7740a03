"""Plain PyTorch version of the PAop kernel.

Same math as :mod:`repro_torch.core.paop`, re-exposed in the kernel's
calling convention: the wrapper runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from repro_torch.core.paop import paop_apply

__all__ = ["paop_ref", "probe_ref"]


def paop_ref(x_e, lam_w, mu_w, jinv, B, G):
    """x_e: (nelem, 3, D1D, D1D, D1D) element-first framework layout."""
    return paop_apply(x_e, lam_w, mu_w, jinv, B, G)


def probe_ref(x):
    """Plain version of the probe kernel."""
    return 2.0 * x
