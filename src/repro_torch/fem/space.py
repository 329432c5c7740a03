"""H1-conforming tensor-product finite element space on a structured hex
mesh, with the E-vector <-> L-vector transitions (the G / G^T operators of
the MFEM chain A = P^T G^T B^T D B G P).

Global scalar DoFs live on the tensor grid of GLL nodes:
``(Nx, Ny, Nz) = (nx*p + 1, ny*p + 1, nz*p + 1)`` with lexicographic
numbering (x fastest).  The displacement L-vector is a ``(nscalar, 3)``
tensor; the E-vector is ``(nelem, 3, D1D, D1D, D1D)`` with layout
``[e, c, iz, iy, ix]``.

``scatter_add`` is deterministic: a node->(element, local-dof) incidence
table built once in numpy (at most 8 slots per hex node, padding slots
point at a zero row) turns G^T into one gather plus a fixed-order sum
over the slot axis.  No atomics, so a solve on the card repeats bitwise,
and the slots run in element order, the order the reference's
``segment_sum`` accumulates in.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.basis import BasisTables, basis_tables
from repro_torch.fem.mesh import HexMesh

__all__ = ["H1Space", "VDIM"]

VDIM = 3

# Face name -> (axis, side) for the box boundary.
_FACES = {
    "x0": (0, 0), "x1": (0, 1),
    "y0": (1, 0), "y1": (1, 1),
    "z0": (2, 0), "z1": (2, 1),
}


@dataclasses.dataclass(frozen=True)
class H1Space:
    """Vector-valued H1 space of degree p on a structured hex mesh."""

    mesh: HexMesh
    p: int

    # -- basic sizes --------------------------------------------------------
    @property
    def tables(self) -> BasisTables:
        return basis_tables(self.p)

    @property
    def d1d(self) -> int:
        return self.p + 1

    @property
    def node_grid(self) -> tuple[int, int, int]:
        m = self.mesh
        return (m.nx * self.p + 1, m.ny * self.p + 1, m.nz * self.p + 1)

    @property
    def nscalar(self) -> int:
        nx, ny, nz = self.node_grid
        return nx * ny * nz

    @property
    def ndof(self) -> int:
        """True (vector) DoF count, the paper's reported metric."""
        return VDIM * self.nscalar

    @property
    def nelem(self) -> int:
        return self.mesh.nelem

    # -- element-restriction indices ----------------------------------------
    @functools.cached_property
    def gather_ids(self) -> np.ndarray:
        """(nelem, D1D, D1D, D1D) int32 global scalar-node ids, layout
        [e, iz, iy, ix]."""
        p, d1 = self.p, self.d1d
        m = self.mesh
        nx_n, ny_n, _ = self.node_grid
        loc = np.arange(d1)
        gx = np.arange(m.nx)[:, None] * p + loc[None, :]  # (nx, D1D)
        gy = np.arange(m.ny)[:, None] * p + loc[None, :]
        gz = np.arange(m.nz)[:, None] * p + loc[None, :]
        # e = ex + nx*(ey + ny*ez); build ids[ez, ey, ex, iz, iy, ix].
        ids = (
            gx[None, None, :, None, None, :]
            + nx_n * gy[None, :, None, None, :, None]
            + nx_n * ny_n * gz[:, None, None, :, None, None]
        )
        return ids.reshape(m.nelem, d1, d1, d1).astype(np.int32)

    @functools.cached_property
    def incidence(self) -> np.ndarray:
        """(nscalar, nslot) int64 node -> E-vector row table.

        Row ``r = e * D1D^3 + local`` of the ``(nelem * D1D^3 + 1, 3)``
        row view of an E-vector holds element ``e``'s three components
        at local node ``local``; the extra last row is zero and every
        unused slot points at it.  Slots list a node's rows in
        increasing element order.  ``nslot`` is the largest node
        multiplicity (8 for an interior hex node)."""
        ids = self.gather_ids.reshape(-1).astype(np.int64)
        order = np.argsort(ids, kind="stable")
        counts = np.bincount(ids, minlength=self.nscalar)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(ids.size) - np.repeat(start, counts)
        table = np.full((self.nscalar, int(counts.max())), ids.size, np.int64)
        table[ids[order], slot] = order
        return table

    @functools.cached_property
    def _device_index(self) -> dict:
        return {}

    def _index(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(gather, incidence) index tensors on ``device``, built once."""
        key = str(device)
        if key not in self._device_index:
            gather = (
                self.gather_ids.astype(np.int64)[:, None] * VDIM
                + np.arange(VDIM).reshape(1, VDIM, 1, 1, 1)
            )  # (nelem, 3, D, D, D) flat ids into the (nscalar, 3) L-vector
            self._device_index[key] = (
                torch.from_numpy(gather).to(device),
                torch.from_numpy(self.incidence).to(device),
            )
        return self._device_index[key]

    # -- E <-> L ---------------------------------------------------------------
    def to_evec(self, u: torch.Tensor) -> torch.Tensor:
        """L-vector (..., nscalar, 3) -> E-vector (..., nelem, 3, D1D, D1D,
        D1D); leading axes (a scenario batch) are kept."""
        gather, _ = self._index(u.device)
        return u.reshape(u.shape[:-2] + (-1,))[..., gather]

    def scatter_add(self, ye: torch.Tensor) -> torch.Tensor:
        """E-vector (..., nelem, 3, D1D, D1D, D1D) -> L-vector (..., nscalar,
        3) via G^T (sum of element contributions at shared nodes, fixed
        order).  Each leading index (scenario row) reduces over the same
        slots in the same order as an unbatched call."""
        _, table = self._index(ye.device)
        ne, d3 = self.nelem, self.d1d ** 3
        lead = ye.shape[:-5]
        rows = ye.new_empty(lead + (ne * d3 + 1, VDIM))
        rows[..., -1, :] = 0
        rows[..., :-1, :].view(lead + (ne, d3, VDIM)).copy_(
            ye.reshape(lead + (ne, VDIM, d3)).transpose(-1, -2)
        )
        g = rows[..., table, :]  # (..., nscalar, nslot, 3): the one gather
        out = g[..., 0, :]
        for s in range(1, g.shape[-2]):
            out = out + g[..., s, :]
        return out.contiguous()

    # -- boundary -----------------------------------------------------------
    def face_node_ids(self, face: str) -> np.ndarray:
        """Scalar node ids on a box face ('x0', 'x1', 'y0', ...)."""
        axis, side = _FACES[face]
        nx, ny, nz = self.node_grid
        sel = [np.arange(nx), np.arange(ny), np.arange(nz)]
        sel[axis] = np.array([0 if side == 0 else self.node_grid[axis] - 1])
        IX, IY, IZ = np.meshgrid(*sel, indexing="ij")
        ids = IX + nx * (IY + ny * IZ)
        return ids.reshape(-1).astype(np.int32)

    def essential_mask(self, faces=("x0",)) -> np.ndarray:
        """(nscalar, 3) bool — True where the DoF is Dirichlet-constrained.
        The paper clamps all displacement components on boundary attribute 1
        (the x=0 face of the beam)."""
        mask = np.zeros((self.nscalar, VDIM), dtype=bool)
        for f in faces:
            mask[self.face_node_ids(f)] = True
        return mask

    # -- load vectors ---------------------------------------------------------
    def traction_rhs(self, face: str, traction, dtype=np.float64) -> np.ndarray:
        """Assemble F_i = int_Gamma t . phi_i dGamma on a box face with a
        constant traction vector (paper: t = (0, 0, -1e-2) on attr 2 = x1).

        Tensor-product face quadrature: on the structured grid the face
        integral reduces to an outer product of 1D lumped weight lines.
        """
        t = np.asarray(traction, dtype=dtype)
        axis, _ = _FACES[face]
        tb = self.tables
        F = np.zeros((self.nscalar, VDIM), dtype=dtype)
        tang = [a for a in range(3) if a != axis]
        h = self.mesh.h
        w1 = []
        for a in tang:
            s = (tb.qwts @ tb.B) * (h[a] / 2.0)  # (D1D,)
            n_el = self.mesh.shape[a]
            line = np.zeros(n_el * self.p + 1, dtype=dtype)
            for e in range(n_el):
                line[e * self.p : e * self.p + self.d1d] += s
            w1.append(line)
        if self.mesh.linear_map is not None:
            A = np.asarray(self.mesh.linear_map)
            # area scaling = |(A e_t1) x (A e_t2)| for unit tangent vectors
            F_scale = np.linalg.norm(np.cross(A[:, tang[0]], A[:, tang[1]]))
        else:
            F_scale = 1.0
        ids = self.face_node_ids(face)
        face_w = np.outer(w1[0], w1[1]).reshape(-1)  # (n_t1 * n_t2,) "ij"
        F[ids] = F_scale * face_w[:, None] * t[None, :]
        return F
