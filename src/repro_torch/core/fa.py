"""Full Assembly (FA): the global sparse stiffness matrix the paper
compares against (Sec. 2.2.1) and the coarse-level matrix of the GMG
preconditioner (Sec. 3.2).

Element matrices are built from the dense 3D gradient table by quadrature
(O((p+1)^6) storage per element — the capacity limitation the paper
demonstrates with its OOM rows in Table 4) and assembled into CSR with
scipy on the host.  The apply runs on the operator's device as an
ELL-padded row sum: every row's nonzeros gathered into a fixed-width
(n, w) table and summed along the row in a fixed order, with no atomics,
so two applies of one matrix to one vector are bitwise equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core.basis import BasisTables
from repro_torch.core.pa_baseline import _dense_grad_table_np
from repro_torch.fem.space import H1Space

__all__ = [
    "element_matrix",
    "assemble_csr",
    "assemble_sparse",
    "SparseMatrix",
    "fa_memory_bytes",
]


def _chat(jinv: np.ndarray, lam: float, mu: float) -> np.ndarray:
    """Reference-pulled-back elasticity tensor
    Chat[i, m, k, n] = sum_{j,l} Jinv[m,j] C_{ijkl} Jinv[n,l]
    for the isotropic C = lam d_ij d_kl + mu (d_ik d_jl + d_il d_jk)."""
    JJt = jinv @ jinv.T
    eye = np.eye(3)
    chat = (
        lam * np.einsum("mi,nk->imkn", jinv, jinv)
        + mu * np.einsum("ik,mn->imkn", eye, JJt)
        + mu * np.einsum("mk,ni->imkn", jinv, jinv)
    )
    return chat


def element_matrix(
    p: int, jinv: np.ndarray, detj: float, lam: float, mu: float
) -> np.ndarray:
    """Dense element stiffness matrix, shape (3*nd, 3*nd) with vdof
    ordering (node-major: dof = 3*node + comp)."""
    tb = BasisTables(p)
    g3 = _dense_grad_table_np(p)  # (3, nq, nd)
    w = tb.qwts
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    chat = _chat(jinv, lam, mu) * detj  # fold detJ; w folded below
    # K[(L,i),(M,k)] = sum_q w3[q] G3[m,q,L] Chat[i,m,k,n] G3[n,q,M]
    K = np.einsum("mqL,q,imkn,nqM->LiMk", g3, w3, chat, g3, optimize=True)
    nd = g3.shape[2]
    return K.reshape(3 * nd, 3 * nd)


@dataclasses.dataclass
class SparseMatrix:
    """CSR matrix with a scipy handle (host ops, factorizations) and an
    ELL-padded copy on the device for the SpMV: ``cols``/``data`` are
    (n, w) with w the longest row; padding slots read index n, a zero
    appended to x, with value 0."""

    csr: sp.csr_matrix
    data: torch.Tensor  # (n, w) values
    cols: torch.Tensor  # (n, w) int32 column ids, n for padding
    n: int

    @classmethod
    def from_scipy(
        cls, m: sp.spmatrix, dtype: torch.dtype = torch.float64, device=None
    ) -> "SparseMatrix":
        csr = m.tocsr()
        csr.sum_duplicates()
        n = csr.shape[0]
        indptr = torch.as_tensor(csr.indptr.astype(np.int64), device=device)
        lengths = indptr[1:] - indptr[:-1]
        width = int(lengths.max())
        row = torch.repeat_interleave(torch.arange(n, device=device), lengths)
        slot = torch.arange(csr.nnz, device=device) - indptr[:-1].repeat_interleave(lengths)
        cols = torch.full((n, width), n, dtype=torch.int32, device=device)
        cols[row, slot] = torch.as_tensor(csr.indices.astype(np.int32), device=device)
        data = torch.zeros((n, width), dtype=dtype, device=device)
        data[row, slot] = torch.as_tensor(csr.data, dtype=dtype, device=device)
        return cls(csr=csr, data=data, cols=cols, n=n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """SpMV y = A x on the device; x flat (n,).  Each row sums its w
        slots in a fixed order (no atomics)."""
        xz = torch.cat([x, x.new_zeros(1)])
        gathered = torch.index_select(xz, 0, self.cols.reshape(-1))
        return (self.data * gathered.view(self.cols.shape)).sum(dim=1)

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    def memory_bytes(self) -> int:
        # The paper's CSR: data (8B) + a 4-byte column index per nnz + the
        # row pointer.  It models that format, not the ELL copy above.
        return self.nnz * 12 + (self.n + 1) * 4


def assemble_csr(
    space: H1Space,
    geom,
    materials: dict[int, tuple[float, float]],
    ess_mask: np.ndarray | None = None,
) -> sp.csr_matrix:
    """Assemble the global sparse stiffness matrix (vdof = 3*node + comp)
    as a scipy CSR matrix on the host, in float64.

    ``geom`` carries the mesh-constant ``jinv`` (3, 3) and ``detj``
    (:class:`~repro_torch.core.geometry.QuadratureGeometry`).  With
    ``ess_mask`` the essential rows/cols are eliminated symmetrically
    (row/col zeroed, unit diagonal) — the assembled analog of
    ConstrainedOperator.
    """
    p = space.p
    jinv = np.asarray(geom.jinv, dtype=np.float64)
    detj = geom.detj
    kmats = {
        a: element_matrix(p, jinv, detj, lam, mu) for a, (lam, mu) in materials.items()
    }
    gid = space.gather_ids.reshape(space.nelem, -1)  # (ne, nd) node ids
    attr = space.mesh.attributes()
    nd = gid.shape[1]
    vdofs = (3 * gid[:, :, None] + np.arange(3)[None, None, :]).reshape(
        space.nelem, 3 * nd
    )

    blocks = np.empty((space.nelem, 3 * nd, 3 * nd))
    for a, K in kmats.items():
        blocks[attr == a] = K

    rows = np.repeat(vdofs, 3 * nd, axis=1).reshape(-1)
    cols = np.tile(vdofs, (1, 3 * nd)).reshape(-1)
    n = 3 * space.nscalar
    A = sp.coo_matrix((blocks.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    del blocks, rows, cols
    A.sum_duplicates()

    if ess_mask is not None:
        ess = np.flatnonzero(np.asarray(ess_mask).reshape(-1))
        keep = np.ones(n, dtype=bool)
        keep[ess] = False
        D = sp.diags(keep.astype(np.float64))
        A = D @ A @ D + sp.diags((~keep).astype(np.float64))
        A = A.tocsr()
        A.eliminate_zeros()
    return A


def assemble_sparse(
    space: H1Space,
    geom,
    materials: dict[int, tuple[float, float]],
    ess_mask: np.ndarray | None = None,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> SparseMatrix:
    """:func:`assemble_csr` with its ELL copy on ``device`` for the SpMV."""
    return SparseMatrix.from_scipy(
        assemble_csr(space, geom, materials, ess_mask), dtype=dtype, device=device
    )


def fa_memory_bytes(space: H1Space) -> int:
    """Analytic FA storage estimate: each scalar row couples to
    O((p+1)^d) neighbours (paper Sec. 2.2.1)."""
    p = space.p
    per_row = 3 * (2 * p + 1) ** 3  # interior-node stencil width, vdim 3
    return space.ndof * per_row * 12
