"""Inter-grid transfer operators for the GMG hierarchy (paper Sec. 3).

On the structured tensor-product grid both transfer kinds are separable
into per-axis 1D operators applied to the global node grid:

* h-transfer (uniform refinement at fixed p): evaluate the coarse
  element basis at the fine nodes of its two children per axis.
* p-transfer (degree embedding on the same mesh): evaluate the degree-p_c
  basis at the degree-p_f GLL nodes per axis.

Prolongation is ``U_f = (Pz x Py x Px) U_c`` applied as three 1D
``torch.einsum`` contractions; restriction is its exact transpose.  The
contractions touch only the trailing axes, so a scenario batch
(S, nscalar, 3) threads through unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.basis import gll_nodes, lagrange_tables
from repro_torch.fem.space import H1Space

__all__ = ["Transfer", "h_transfer_1d", "p_transfer_1d", "make_transfer"]


def p_transfer_1d(n_el: int, p_coarse: int, p_fine: int) -> np.ndarray:
    """Global 1D prolongation (n_el*p_fine+1, n_el*p_coarse+1)."""
    E, _ = lagrange_tables(gll_nodes(p_coarse), gll_nodes(p_fine))
    nf, nc = n_el * p_fine + 1, n_el * p_coarse + 1
    P = np.zeros((nf, nc))
    for e in range(n_el):
        P[e * p_fine : e * p_fine + p_fine + 1, e * p_coarse : e * p_coarse + p_coarse + 1] = E
    return P


def h_transfer_1d(n_el_coarse: int, p: int) -> np.ndarray:
    """Global 1D prolongation from n_el to 2*n_el elements at degree p."""
    nodes = gll_nodes(p)
    El, _ = lagrange_tables(nodes, (nodes - 1.0) / 2.0)
    Er, _ = lagrange_tables(nodes, (nodes + 1.0) / 2.0)
    nf, nc = 2 * n_el_coarse * p + 1, n_el_coarse * p + 1
    P = np.zeros((nf, nc))
    for e in range(n_el_coarse):
        P[(2 * e) * p : (2 * e) * p + p + 1, e * p : e * p + p + 1] = El
        P[(2 * e + 1) * p : (2 * e + 1) * p + p + 1, e * p : e * p + p + 1] = Er
    return P


@dataclasses.dataclass
class Transfer:
    """Separable 3D transfer between two H1 spaces on the same box, on
    (..., nscalar, 3) L-vectors."""

    px: torch.Tensor  # (Nx_f, Nx_c)
    py: torch.Tensor
    pz: torch.Tensor
    grid_c: tuple[int, int, int]
    grid_f: tuple[int, int, int]

    def prolong(self, u_c):
        """(..., nscalar_c, 3) -> (..., nscalar_f, 3)."""
        nxc, nyc, nzc = self.grid_c
        lead = u_c.shape[:-2]
        u = u_c.reshape(lead + (nzc, nyc, nxc, 3))
        u = torch.einsum("...zyxc,Xx->...zyXc", u, self.px)
        u = torch.einsum("...zyXc,Yy->...zYXc", u, self.py)
        u = torch.einsum("...zYXc,Zz->...ZYXc", u, self.pz)
        return u.reshape(lead + (-1, 3))

    def restrict(self, r_f):
        """Transpose: (..., nscalar_f, 3) -> (..., nscalar_c, 3)."""
        nxf, nyf, nzf = self.grid_f
        lead = r_f.shape[:-2]
        r = r_f.reshape(lead + (nzf, nyf, nxf, 3))
        r = torch.einsum("...ZYXc,Zz->...zYXc", r, self.pz)
        r = torch.einsum("...zYXc,Yy->...zyXc", r, self.py)
        r = torch.einsum("...zyXc,Xx->...zyxc", r, self.px)
        return r.reshape(lead + (-1, 3))

def make_transfer(
    coarse: H1Space, fine: H1Space, *, dtype: torch.dtype, device
) -> Transfer:
    """Build the transfer between two nested spaces: either an h-refinement
    at equal degree or a p-embedding on the same mesh."""
    mc, mf = coarse.mesh, fine.mesh
    if mc.shape == mf.shape and coarse.p != fine.p:
        mats = [p_transfer_1d(n, coarse.p, fine.p) for n in mc.shape]
    elif tuple(2 * n for n in mc.shape) == mf.shape and coarse.p == fine.p:
        mats = [h_transfer_1d(n, coarse.p) for n in mc.shape]
    else:
        raise ValueError(
            f"spaces not nested: {mc.shape}@p={coarse.p} -> {mf.shape}@p={fine.p}"
        )
    px, py, pz = (torch.as_tensor(m, dtype=dtype, device=device) for m in mats)
    return Transfer(
        px=px, py=py, pz=pz, grid_c=coarse.node_grid, grid_f=fine.node_grid
    )
