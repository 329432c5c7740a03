"""Structured affine hexahedral meshes.

The paper's benchmark domain is MFEM's ``beam-hex`` mesh: an 8x1x1
structured hexahedral block with two element attributes (a 50:1 material
contrast), Dirichlet boundary attribute 1 on the x=0 face and Neumann
traction attribute 2 on the x=Lx face.  Uniform refinement doubles the
element count per direction; elements stay affine, so the Jacobian is
constant per element.

An optional ``linear_map`` applies a global affine map A x + b to the
box, producing non-diagonal (but still per-element-constant) Jacobians.
Setup-time numpy, like the reference module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HexMesh", "beam_hex", "fine_descendants"]


@dataclasses.dataclass(frozen=True)
class HexMesh:
    """A structured nx x ny x nz hexahedral box mesh.

    Element ordering is lexicographic with ``ex`` fastest:
    ``e = ex + nx * (ey + ny * ez)``.
    """

    nx: int
    ny: int
    nz: int
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Element attribute (material id), shape (nelem,), values in {1, 2, ...}.
    elem_attr: np.ndarray | None = None
    # Optional global affine map (3x3); identity if None.
    linear_map: np.ndarray | None = None

    def __post_init__(self):
        if self.elem_attr is not None:
            object.__setattr__(
                self, "elem_attr", np.asarray(self.elem_attr, dtype=np.int32)
            )
            if self.elem_attr.shape != (self.nelem,):
                raise ValueError(
                    f"elem_attr shape {self.elem_attr.shape} != ({self.nelem},)"
                )

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def nelem(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def h(self) -> tuple[float, float, float]:
        lx, ly, lz = self.lengths
        return (lx / self.nx, ly / self.ny, lz / self.nz)

    def attributes(self) -> np.ndarray:
        if self.elem_attr is not None:
            return self.elem_attr
        return np.ones(self.nelem, dtype=np.int32)

    def refined(self, times: int = 1) -> "HexMesh":
        """Uniform refinement: each element splits into 8 children that
        inherit the parent's attribute."""
        mesh = self
        for _ in range(times):
            f = 2
            attr = mesh.attributes().reshape(mesh.nz, mesh.ny, mesh.nx)
            attr = np.repeat(np.repeat(np.repeat(attr, f, 0), f, 1), f, 2)
            mesh = HexMesh(
                mesh.nx * f,
                mesh.ny * f,
                mesh.nz * f,
                mesh.lengths,
                attr.reshape(-1),
                mesh.linear_map,
            )
        return mesh

    def jacobian(self) -> np.ndarray:
        """Per-element-constant Jacobian of the reference->physical map
        ([-1,1]^3 reference cube), shape (3, 3); identical for all elements
        of a uniform box, possibly non-diagonal under ``linear_map``."""
        hx, hy, hz = self.h
        J = np.diag([hx / 2.0, hy / 2.0, hz / 2.0])
        if self.linear_map is not None:
            J = np.asarray(self.linear_map) @ J
        return J


def fine_descendants(coarse: HexMesh, fine: HexMesh) -> np.ndarray:
    """Fine-mesh element ids of every coarse element's descendants under
    uniform refinement, shape (coarse.nelem, f^3) with f = fine.nx //
    coarse.nx.

    Row ``e`` lists the fine elements covering coarse element ``e`` (in
    fine lexicographic order), so a per-element coefficient field given
    on the fine mesh can be restricted to any coarser hierarchy level by
    aggregating each row.  For ``coarse is fine`` this is the identity
    map of shape (nelem, 1)."""
    f, ry, rz = (
        fine.nx // coarse.nx,
        fine.ny // coarse.ny,
        fine.nz // coarse.nz,
    )
    if ry != f or rz != f or (
        coarse.nx * f,
        coarse.ny * f,
        coarse.nz * f,
    ) != fine.shape or f < 1 or (f & (f - 1)):
        raise ValueError(
            f"{fine.shape} is not a uniform power-of-two refinement of "
            f"{coarse.shape}"
        )
    d = np.arange(f)
    fx = f * np.arange(coarse.nx)[:, None] + d[None, :]  # (nx, f)
    fy = f * np.arange(coarse.ny)[:, None] + d[None, :]
    fz = f * np.arange(coarse.nz)[:, None] + d[None, :]
    idx = (
        fx[None, None, :, None, None, :]
        + fine.nx
        * (
            fy[None, :, None, None, :, None]
            + fine.ny * fz[:, None, None, :, None, None]
        )
    )  # (nz, ny, nx, f_z, f_y, f_x)
    return np.ascontiguousarray(
        idx.reshape(coarse.nelem, f**3).astype(np.int32)
    )


def beam_hex(nx: int = 8, ny: int = 1, nz: int = 1) -> HexMesh:
    """The MFEM ``beam-hex`` benchmark beam: x in [0, 8], unit cross
    section, attribute 1 for x < 4 (stiff: lambda=mu=50) and attribute 2
    for x >= 4 (soft: lambda=mu=1)."""
    ex = np.arange(nx)
    attr_x = np.where(ex < nx // 2, 1, 2).astype(np.int32)
    attr = np.tile(attr_x, ny * nz)
    return HexMesh(nx, ny, nz, lengths=(8.0, 1.0, 1.0), elem_attr=attr)
