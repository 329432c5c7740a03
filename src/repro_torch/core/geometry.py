"""Affine geometry factors and per-element material fields (the "D" of
the operator chain A = P^T G^T B^T D B G P).

For affine tensor-product hexahedra J, det(J) and J^{-1} are constant
per element and precomputed once (paper Sec. 4.4).  Setup-time numpy in
float64; operators cast to their dtype and device when they bind.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.basis import BasisTables
from repro_torch.fem.mesh import HexMesh

__all__ = [
    "QuadratureGeometry",
    "quadrature_geometry",
    "material_fields",
    "check_material_dict",
    "check_material_fields",
    "MATERIALS_BEAM",
]

# Paper Sec. 5.1.4: attribute 1 -> lambda = mu = 50, attribute 2 -> 1.
MATERIALS_BEAM = {1: (50.0, 50.0), 2: (1.0, 1.0)}


@dataclasses.dataclass
class QuadratureGeometry:
    """Material-independent part of the stored PA data."""

    # (Q1D, Q1D, Q1D): w_q * det(J), separable quadrature weights times
    # the (globally constant) Jacobian determinant.
    w_detj: Any
    jinv: Any  # (3, 3)
    detj: float


def quadrature_geometry(
    mesh: HexMesh, tables: BasisTables, dtype=np.float64
) -> QuadratureGeometry:
    """Geometry factors of the D-data for an affine box mesh."""
    J = mesh.jacobian()
    detj = float(np.linalg.det(J))
    if detj <= 0:
        raise ValueError("mesh Jacobian must have positive determinant")
    jinv = np.linalg.inv(J)
    w = tables.qwts
    w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]  # (Q,Q,Q)
    return QuadratureGeometry(
        w_detj=(w3 * detj).astype(dtype), jinv=jinv.astype(dtype), detj=detj
    )


def material_fields(
    mesh: HexMesh,
    materials: dict[int, tuple[float, float]] | None = None,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-element (lambda_e, mu_e) coefficient fields from an
    attribute -> (lambda, mu) table, each of shape (nelem,)."""
    materials = materials or MATERIALS_BEAM
    attr = mesh.attributes()
    lam_e = np.empty(mesh.nelem, dtype=dtype)
    mu_e = np.empty(mesh.nelem, dtype=dtype)
    for a, (lam, mu) in materials.items():
        sel = attr == a
        lam_e[sel] = lam
        mu_e[sel] = mu
    known = np.isin(attr, list(materials))
    if not known.all():
        raise ValueError(f"elements with unknown attributes: {set(attr[~known])}")
    return lam_e, mu_e


def check_material_dict(materials: dict, attrs, *, where: str = "materials") -> None:
    """Validate an attribute -> (lambda, mu) dict against a mesh's
    attribute set: every mesh attribute must be covered and every
    coefficient must be positive."""
    attr_set = {int(a) for a in np.unique(np.asarray(attrs))}
    missing = attr_set - {int(a) for a in materials}
    if missing:
        raise ValueError(
            f"{where}: missing mesh attributes {sorted(missing)} "
            f"(mesh has {tuple(sorted(attr_set))})"
        )
    for a in sorted(materials):
        try:
            lam, mu = materials[a]
            lam, mu = float(lam), float(mu)
        except (TypeError, ValueError):
            raise ValueError(
                f"{where}: attribute {a} must map to a (lambda, mu) "
                f"pair, got {materials[a]!r}"
            ) from None
        if not (lam > 0 and mu > 0):  # also catches NaN
            raise ValueError(
                f"{where}: attribute {a} has non-positive coefficients "
                f"(lambda, mu) = ({lam}, {mu}); both must be > 0"
            )


def check_material_fields(
    lam_e, mu_e, nelem: int, *, where: str = "materials"
) -> tuple[np.ndarray, np.ndarray]:
    """Validate a per-element (lam_e, mu_e) coefficient pair: both of
    shape (nelem,), every entry positive.  Returns float64 numpy arrays."""
    lam_e = np.asarray(lam_e, dtype=np.float64)
    mu_e = np.asarray(mu_e, dtype=np.float64)
    for name, f in (("lam_e", lam_e), ("mu_e", mu_e)):
        if f.shape != (nelem,):
            raise ValueError(
                f"{where}: {name} has shape {f.shape}, expected ({nelem},) "
                f"— one coefficient per fine-mesh element"
            )
        bad = np.flatnonzero(~(f > 0))  # ~(x > 0) also catches NaN
        if bad.size:
            e = int(bad[0])
            n = int(bad.size)
            raise ValueError(
                f"{where}: {name}[{e}] = {f[e]} is not positive "
                f"({n} non-positive entr{'y' if n == 1 else 'ies'}; "
                f"all coefficients must be > 0)"
            )
    return lam_e, mu_e
