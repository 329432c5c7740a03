"""ElasticityOperator: the paper's contribution as a composable module.

One operator object per (mesh, degree) pair exposes every assembly level
of the paper's ablation (Table 7) behind a single interface consumed by
the solvers:

* ``"fa"`` — the globally assembled sparse matrix (:mod:`repro_torch.core.fa`),
  scipy CSR on the host, applied on the device by a fixed-order row sum;
* ``"pa_baseline"`` — MFEM v4.8's two-kernel PA dataflow with the dense
  O((p+1)^6) gradient table (paper Algorithm 1, :mod:`repro_torch.core.pa_baseline`);
* ``"pa_sumfact"`` / ``"pa_sumfact_voigt"`` — the sum-factorized but unfused
  stages C1 and C2 (:mod:`repro_torch.core.pa_sumfact`);
* ``"paop"`` — the plain PyTorch PAop (:func:`repro_torch.core.paop.paop_apply`);
* ``"paop_cuda"`` — the hand-written CUDA kernel through
  :func:`repro_torch.kernels.pa_elasticity.ops.pa_elasticity`, the
  counterpart of the reference's ``paop_pallas``.  The default.  For CPU
  tensors the wrapper runs the plain version.

``apply(x)`` acts on the unconstrained L-vector (nscalar, 3);
``constrained()`` wraps it with MFEM ConstrainedOperator semantics and
the matrix-free diagonal for the Chebyshev-Jacobi smoother.  Materials
are one attribute->(lambda, mu) dict, one per-element ``(lam_e, mu_e)``
pair of (nelem,) arrays, or a scenario *sequence* of such entries (dicts
and pairs mixed freely, one per scenario).  ``fa`` takes one dict only.

Scenario batching (matrix-free levels): with a scenario sequence (or
fields of shape (S, nelem) bound through
:meth:`ElasticityOperator.with_materials`) the operator acts on
(S, nscalar, 3) L-vectors.  The scenario axis is folded into the element
axis, so the element operator runs unchanged on S * nelem elements.
``materials=DEFER_MATERIALS`` builds a geometry carrier whose fields are
bound later; the ``with_*`` methods return shallow copies that share
geometry, tables and masks (and do not run the probe again).

bfloat16 (the ``mixed-bf16`` V-cycle): vectors and the weighted fields
``lam_w``/``mu_w`` are bfloat16 (the bytes the element operator streams),
while the geometry and basis tables stay float32 (``table_dtype``): every
matrix-free level computes in float32 and rounds y_e to bfloat16 once, as
the PAop kernel's bfloat16 instantiation does.  bfloat16 tables would
break G's zero row sums, and with them the rigid-body modes a multigrid
V-cycle relies on.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.core import diagonal as _diag
from repro_torch.core import fa as _fa
from repro_torch.core import pa_baseline as _base
from repro_torch.core import pa_sumfact as _sf
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

__all__ = ["ElasticityOperator", "ASSEMBLY_LEVELS", "DEFER_MATERIALS", "fused_level"]

# Sentinel: build the operator as a geometry/tables carrier only; material
# fields are bound later through with_materials / with_material_weights.
DEFER_MATERIALS = "defer"

ASSEMBLY_LEVELS = (
    "fa",
    "pa_baseline",
    "pa_sumfact",
    "pa_sumfact_voigt",
    "paop",
    "paop_cuda",
)


def fused_level(assembly: str, device) -> str:
    """The level of the GMG coarsest operator for a hierarchy of
    ``assembly``: ``fa`` keeps ``fa``; a fused level keeps itself; any
    other level takes the fused operator of its device (``paop_cuda`` on
    the card, ``paop`` on the CPU), as the reference takes its ``paop``."""
    if assembly in ("fa", "paop", "paop_cuda"):
        return assembly
    return "paop_cuda" if torch.device(device).type == "cuda" else "paop"


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
        self.table_dtype = _kops.TABLE_DTYPE.get(dtype, dtype)
        self.tables = space.tables
        if assembly == "paop_cuda" and self.device.type == "cuda":
            _kops.check_probe(self.device)

        geom = quadrature_geometry(space.mesh, self.tables)
        self._set_tables(geom)
        self.ess_mask = torch.as_tensor(
            space.essential_mask(ess_faces), device=self.device
        )
        if isinstance(materials, str) and materials == DEFER_MATERIALS:
            if assembly == "fa":
                raise ValueError("assembly='fa' cannot defer materials")
            self.materials = None
            self.nbatch = None
            self.lam_w = self.mu_w = None
        else:
            self.materials = materials if materials is not None else MATERIALS_BEAM
            self._bind_materials(*self._normalize_materials(self.materials))

        self._g3d = None
        if assembly == "pa_baseline":
            self._g3d = _base.dense_grad_table(
                space.p, dtype=self.table_dtype, device=self.device
            )
        self._sparse: _fa.SparseMatrix | None = None
        if assembly == "fa":
            if self.nbatch is not None or not isinstance(self.materials, dict):
                raise ValueError(
                    "assembly='fa' supports only a single attribute->"
                    "(lambda, mu) dict; use a matrix-free level for "
                    "scenario-batched or per-element materials"
                )
            # Assembled from the float64 geometry, whatever the dtype.
            self._sparse = _fa.assemble_sparse(
                space, geom, self.materials, dtype=dtype, device=self.device
            )

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _table(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.table_dtype, device=self.device)

    def _set_tables(self, geom) -> None:
        self.w_detj = self._table(geom.w_detj)  # (Q,Q,Q)
        self.jinv = self._table(geom.jinv)
        self.B = self._table(self.tables.B)
        self.G = self._table(self.tables.G)

    def _weighted(self, field_e: torch.Tensor) -> torch.Tensor:
        """``field_e * w_detj`` at the quadrature points, (n, Q, Q, Q) from
        (n,), formed in the table dtype and rounded to the operator's
        dtype once."""
        return (field_e.reshape(-1)[:, None, None, None] * self.w_detj).to(self.dtype)

    @staticmethod
    def _is_field_pair(m) -> bool:
        """A (lam_e, mu_e) scenario entry: two 1-D array-likes."""
        return (
            isinstance(m, (tuple, list))
            and len(m) == 2
            and np.ndim(m[0]) == 1
            and np.ndim(m[1]) == 1
        )

    def _normalize_materials(self, materials):
        """Per-element coefficient fields (lam_e, mu_e), each (nelem,) for
        one scenario or (S, nelem) for a scenario sequence, as numpy
        arrays.  A pre-stacked (S, nelem) pair is refused here (it is bound
        through :meth:`with_materials`): a sequence of per-scenario entries
        is never mistaken for one stacked pair, or the other way round."""
        mesh = self.space.mesh
        if isinstance(materials, dict):
            return material_fields(mesh, materials)
        if (
            isinstance(materials, (list, tuple))
            and materials
            and not self._is_field_pair(materials)
            and all(isinstance(m, dict) or self._is_field_pair(m) for m in materials)
        ):
            fields = [
                material_fields(mesh, m)
                if isinstance(m, dict)
                else (np.asarray(m[0]), np.asarray(m[1]))
                for m in materials
            ]
            return np.stack([f[0] for f in fields]), np.stack([f[1] for f in fields])
        try:
            lam_e, mu_e = materials
        except (TypeError, ValueError):
            raise TypeError(
                "materials must be an attribute->(lambda, mu) dict, a "
                "(lam_e, mu_e) pair of per-element arrays, or a sequence of "
                f"dicts / pairs (one per scenario); got {type(materials)!r}"
            ) from None
        if np.ndim(lam_e) != 1 or np.ndim(mu_e) != 1:
            raise ValueError(
                f"material fields of {np.ndim(lam_e)}/{np.ndim(mu_e)} dimensions: "
                f"the constructor takes scenario batches as a sequence of "
                f"per-scenario entries; bind stacked (S, nelem) fields with "
                f"with_materials"
            )
        return lam_e, mu_e

    def _bind_materials(self, lam_e, mu_e) -> None:
        """Set lam_w/mu_w from (nelem,) or (S, nelem) coefficient fields;
        a leading scenario axis is folded into the element axis."""
        lam_e, mu_e = self._table(lam_e), self._table(mu_e)
        ne = self.space.nelem
        if (
            lam_e.shape != mu_e.shape
            or lam_e.ndim not in (1, 2)
            or lam_e.shape[-1] != ne
        ):
            raise ValueError(
                f"material fields {tuple(lam_e.shape)}/{tuple(mu_e.shape)} must "
                f"both be ({ne},) or (S, {ne})"
            )
        self.nbatch = lam_e.shape[0] if lam_e.ndim == 2 else None
        self.lam_w = self._weighted(lam_e)
        self.mu_w = self._weighted(mu_e)

    def with_materials(self, lam_e, mu_e) -> "ElasticityOperator":
        """A shallow copy with new coefficient fields, (nelem,) or
        (S, nelem); geometry, tables and masks are shared."""
        if self.assembly == "fa":
            raise ValueError("with_materials is matrix-free only (not 'fa')")
        new = copy.copy(self)
        new.materials = None
        new._bind_materials(lam_e, mu_e)
        return new

    def with_material_weights(self, lam_w, mu_w, nbatch: int | None) -> "ElasticityOperator":
        """A shallow copy binding precomputed weighted fields
        (``lam_e * w_detj``) directly: for a scenario batch ``lam_w`` is the
        folded (S * nelem, Q, Q, Q) tensor and ``nbatch`` is S."""
        if self.assembly == "fa":
            raise ValueError("with_material_weights is matrix-free only")
        new = copy.copy(self)
        new.materials = None
        new.nbatch = nbatch
        new.lam_w = lam_w
        new.mu_w = mu_w
        return new

    def with_dtype(self, dtype: torch.dtype) -> "ElasticityOperator":
        """A shallow copy computing in ``dtype``: geometry and basis tables
        rebuilt from the float64 geometry, the bound weighted fields cast
        (a bfloat16 operator's fields upcast exactly).  Matrix-free only."""
        if self.assembly == "fa":
            raise ValueError("with_dtype is matrix-free only (not 'fa')")
        new = copy.copy(self)
        new.dtype = dtype
        new.table_dtype = _kops.TABLE_DTYPE.get(dtype, dtype)
        new._set_tables(quadrature_geometry(self.space.mesh, self.tables))
        if self.lam_w is not None:
            new.lam_w, new.mu_w = self.lam_w.to(dtype), self.mu_w.to(dtype)
        if self.assembly == "pa_baseline":
            new._g3d = _base.dense_grad_table(
                self.space.p, dtype=new.table_dtype, device=self.device
            )
        return new

    def with_materials_rows(self, lam_e, mu_e, row_mask) -> "ElasticityOperator":
        """Per-scenario-row field update: rows selected by ``row_mask`` (S,)
        take freshly weighted fields from the (S, nelem) candidates; the
        other rows keep this operator's fields bitwise."""
        if self.assembly == "fa":
            raise ValueError("with_materials_rows is matrix-free only")
        if self.nbatch is None:
            raise ValueError("with_materials_rows requires a scenario-batched operator")
        s, ne = self.nbatch, self.space.nelem
        lam_e, mu_e = self._table(lam_e), self._table(mu_e)
        if lam_e.shape != (s, ne) or mu_e.shape != (s, ne):
            raise ValueError(
                f"candidate fields {tuple(lam_e.shape)}/{tuple(mu_e.shape)} must "
                f"be ({s}, {ne})"
            )
        mask = torch.as_tensor(row_mask, device=self.device).reshape((s,) + (1,) * 4)

        def merge(old_w, cand_e):
            cand_w = self._weighted(cand_e)
            tail = old_w.shape[1:]
            return torch.where(
                mask, cand_w.reshape((s, ne) + tail), old_w.reshape((s, ne) + tail)
            ).reshape((s * ne,) + tail)

        new = copy.copy(self)
        new.materials = None
        new.lam_w = merge(self.lam_w, lam_e)
        new.mu_w = merge(self.mu_w, mu_e)
        return new

    # -- raw action ---------------------------------------------------------
    def _apply_evec(self, x_e):
        if self.lam_w is None:
            raise ValueError("materials are deferred; bind them with with_materials first")
        a = self.assembly
        if a == "paop_cuda":
            return _kops.pa_elasticity(x_e, self.lam_w, self.mu_w, self.jinv, self.B, self.G)
        # The plain levels compute in the table dtype (bfloat16 operands
        # upcast, y_e rounded once, as the kernel does).
        t = self.table_dtype
        x_t, lam_t, mu_t = x_e.to(t), self.lam_w.to(t), self.mu_w.to(t)
        if a == "pa_baseline":
            y = _base.pa_baseline_apply(x_t, lam_t, mu_t, self.jinv, self._g3d)
        else:
            args = (x_t, lam_t, mu_t, self.jinv, self.B, self.G)
            if a == "pa_sumfact":
                y = _sf.pa_sumfact_apply(*args)
            elif a == "pa_sumfact_voigt":
                y = _sf.pa_sumfact_voigt_apply(*args)
            else:
                y = _paop.paop_apply(*args)
        return y.to(self.dtype)

    def apply(self, x):
        """Unconstrained y = A x on the L-vector (nscalar, 3), or on the
        scenario batch (S, nscalar, 3) of a batched operator."""
        if self.assembly == "fa":
            return self._sparse.matvec(x.reshape(-1)).reshape(x.shape)
        x_e = self.space.to_evec(x)
        if self.nbatch is None:
            return self.space.scatter_add(self._apply_evec(x_e))
        s, ne = self.nbatch, self.space.nelem
        y_e = self._apply_evec(x_e.reshape((s * ne,) + x_e.shape[2:]))
        return self.space.scatter_add(y_e.reshape((s, ne) + y_e.shape[1:]))

    def __call__(self, x):
        return self.apply(x)

    # -- diagonal -------------------------------------------------------------
    def diagonal(self):
        """Assembled operator diagonal as an L-vector (nscalar, 3), with a
        leading scenario axis for a batched operator."""
        if self.assembly == "fa":
            return self._tensor(self._sparse.csr.diagonal()).reshape(-1, 3)
        if self.lam_w is None:
            raise ValueError("materials are deferred; bind them with with_materials first")
        t = self.table_dtype
        d_e = _diag.element_diagonal(
            self.lam_w.to(t), self.mu_w.to(t), self.jinv, self.B, self.G
        ).to(self.dtype)
        if self.nbatch is not None:
            d_e = d_e.reshape((self.nbatch, self.space.nelem) + d_e.shape[1:])
        return self.space.scatter_add(d_e)

    # -- constrained view -------------------------------------------------------
    def constrained(self) -> ConstrainedOperator:
        return ConstrainedOperator(self.apply, self.ess_mask, self.diagonal)

    # -- introspection ------------------------------------------------------------
    def memory_bytes(self) -> int:
        """Stored-operator footprint: quadrature data D for PA levels, CSR
        for FA (paper Fig. 4 peak-memory comparison)."""
        if self.assembly == "fa":
            return self._sparse.memory_bytes()
        return int(sum(t.numel() * t.element_size() for t in (self.lam_w, self.mu_w, self.jinv)))
