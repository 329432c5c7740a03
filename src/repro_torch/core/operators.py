"""ElasticityOperator: the paper's contribution as a composable module.

One operator object per (mesh, degree) pair, single scenario, with two
assembly levels:

* ``"paop"`` — the plain PyTorch PAop (:func:`repro_torch.core.paop.paop_apply`),
  the counterpart of the reference's ``paop``;
* ``"paop_cuda"`` — the hand-written CUDA kernel through
  :func:`repro_torch.kernels.pa_elasticity.ops.pa_elasticity`, the
  counterpart of the reference's ``paop_pallas``.  The default.  For CPU
  tensors the wrapper runs the plain version.

``apply(x)`` acts on the unconstrained L-vector (nscalar, 3);
``constrained()`` wraps it with MFEM ConstrainedOperator semantics and
the matrix-free diagonal for the Chebyshev-Jacobi smoother.  Materials
are one attribute->(lambda, mu) dict or one per-element ``(lam_e, mu_e)``
pair of (nelem,) arrays.
"""

from __future__ import annotations

import torch

from repro_torch.core import diagonal as _diag
from repro_torch.core import paop as _paop
from repro_torch.core.geometry import (
    MATERIALS_BEAM,
    material_fields,
    quadrature_geometry,
)
from repro_torch.device import resolve_device
from repro_torch.fem.bc import ConstrainedOperator
from repro_torch.fem.space import H1Space
from repro_torch.kernels.pa_elasticity import ops as _kops

__all__ = ["ElasticityOperator", "ASSEMBLY_LEVELS"]

ASSEMBLY_LEVELS = ("paop", "paop_cuda")


class ElasticityOperator:
    def __init__(
        self,
        space: H1Space,
        assembly: str = "paop_cuda",
        materials=None,
        dtype: torch.dtype = torch.float64,
        device=None,
        ess_faces=("x0",),
    ):
        if assembly not in ASSEMBLY_LEVELS:
            raise ValueError(
                f"unknown assembly level {assembly!r}; expected one of "
                f"{ASSEMBLY_LEVELS}"
            )
        self.device = resolve_device(device)
        self.space = space
        self.assembly = assembly
        self.dtype = dtype
        self.tables = space.tables
        if assembly == "paop_cuda" and self.device.type == "cuda":
            _kops.check_probe(self.device)

        geom = quadrature_geometry(space.mesh, self.tables)
        self.w_detj = self._tensor(geom.w_detj)  # (Q,Q,Q)
        self.jinv = self._tensor(geom.jinv)
        self.B = self._tensor(self.tables.B)
        self.G = self._tensor(self.tables.G)
        self.ess_mask = torch.as_tensor(
            space.essential_mask(ess_faces), device=self.device
        )
        self.materials = materials if materials is not None else MATERIALS_BEAM
        lam_e, mu_e = self._normalize_materials(self.materials)
        self.lam_w = lam_e[:, None, None, None] * self.w_detj
        self.mu_w = mu_e[:, None, None, None] * self.w_detj

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _normalize_materials(self, materials) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-element coefficient fields (lam_e, mu_e), each (nelem,), in
        the operator's dtype on its device."""
        if isinstance(materials, dict):
            lam_e, mu_e = material_fields(self.space.mesh, materials)
        else:
            try:
                lam_e, mu_e = materials
            except (TypeError, ValueError):
                raise TypeError(
                    "materials must be an attribute->(lambda, mu) dict or a "
                    f"(lam_e, mu_e) pair of per-element arrays; got "
                    f"{type(materials)!r}"
                ) from None
        lam_e, mu_e = self._tensor(lam_e), self._tensor(mu_e)
        ne = self.space.nelem
        if lam_e.shape != (ne,) or mu_e.shape != (ne,):
            raise ValueError(
                f"material fields {tuple(lam_e.shape)}/{tuple(mu_e.shape)} "
                f"must both be ({ne},); scenario batches are not supported "
                f"by this operator"
            )
        return lam_e, mu_e

    # -- raw action ---------------------------------------------------------
    def _apply_evec(self, x_e):
        args = (x_e, self.lam_w, self.mu_w, self.jinv, self.B, self.G)
        if self.assembly == "paop":
            return _paop.paop_apply(*args)
        return _kops.pa_elasticity(*args)

    def apply(self, x):
        """Unconstrained y = A x on the L-vector (nscalar, 3)."""
        return self.space.scatter_add(self._apply_evec(self.space.to_evec(x)))

    def __call__(self, x):
        return self.apply(x)

    # -- diagonal -------------------------------------------------------------
    def diagonal(self):
        """Assembled operator diagonal as an L-vector (nscalar, 3)."""
        d_e = _diag.element_diagonal(self.lam_w, self.mu_w, self.jinv, self.B, self.G)
        return self.space.scatter_add(d_e)

    # -- constrained view -------------------------------------------------------
    def constrained(self) -> ConstrainedOperator:
        return ConstrainedOperator(self.apply, self.ess_mask, self.diagonal)

    # -- introspection ------------------------------------------------------------
    def memory_bytes(self) -> int:
        """Stored-operator footprint: the quadrature data D."""
        n = self.lam_w.numel() + self.mu_w.numel() + self.jinv.numel()
        return int(n) * self.lam_w.element_size()
