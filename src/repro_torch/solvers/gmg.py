"""Geometric multigrid preconditioner (paper Sec. 3).

Hierarchy: starting from the coarse mesh, ``n_h_refine`` uniform
refinements give levels 0..r at degree p_min = 1; p-refinements then
double the degree until the finest level reaches the target p
(appending p_target itself when it is not a power of two).  Every level
uses the requested matrix-free operator, the coarsest included (the
reference forces its pure-JAX ``paop`` there), so on the card no plain
apply stays on the path.  Fine and intermediate levels smooth with
Chebyshev(k=2)-Jacobi; the coarsest level is solved per
:mod:`repro_torch.solvers.coarse`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.operators import ElasticityOperator
from repro_torch.device import resolve_device
from repro_torch.fem.mesh import HexMesh
from repro_torch.fem.space import H1Space
from repro_torch.fem.transfer import Transfer, make_transfer
from repro_torch.solvers.chebyshev import ChebyshevSmoother
from repro_torch.solvers.coarse import make_coarse_solver

__all__ = [
    "p_chain",
    "hierarchy_spaces",
    "build_hierarchy",
    "GMGPreconditioner",
    "Level",
]


def p_chain(p_target: int) -> list[int]:
    """Degree ladder 1 -> 2 -> 4 -> ... (-> p_target)."""
    chain = [1]
    while chain[-1] * 2 <= p_target:
        chain.append(chain[-1] * 2)
    if chain[-1] != p_target:
        chain.append(p_target)
    return chain


def hierarchy_spaces(
    coarse_mesh: HexMesh, n_h_refine: int, p_target: int
) -> list[H1Space]:
    """The GMG level ladder, coarse -> fine: ``n_h_refine`` uniform
    h-refinements at p = 1, then p-doubling on the finest mesh."""
    meshes = [coarse_mesh]
    for _ in range(n_h_refine):
        meshes.append(meshes[-1].refined())
    spaces = [H1Space(m, 1) for m in meshes]
    for p in p_chain(p_target)[1:]:
        spaces.append(H1Space(meshes[-1], p))
    return spaces


@dataclasses.dataclass
class Level:
    space: H1Space
    operator: ElasticityOperator
    constrained: Callable  # ConstrainedOperator
    smoother: ChebyshevSmoother | None
    ess_mask: torch.Tensor


@dataclasses.dataclass
class GMGPreconditioner:
    levels: list[Level]  # coarse -> fine
    transfers: list[Transfer]  # transfers[i]: level i -> level i+1
    coarse_solve: Callable

    @property
    def fine(self) -> Level:
        return self.levels[-1]

    def __call__(self, r):
        return self._vcycle(len(self.levels) - 1, r)

    def _vcycle(self, l: int, b):
        if l == 0:
            return self.coarse_solve(b)
        lev = self.levels[l]
        x = lev.smoother(b)  # pre-smooth from zero initial guess
        r = b - lev.constrained(x)
        t = self.transfers[l - 1]
        rc = torch.where(self.levels[l - 1].ess_mask, 0.0, t.restrict(r))
        e = self._vcycle(l - 1, rc)
        x = x + t.prolong(e)
        return lev.smoother(b, x)  # post-smooth


def build_hierarchy(
    coarse_mesh: HexMesh,
    n_h_refine: int,
    p_target: int,
    assembly: str = "paop_cuda",
    materials=None,
    dtype: torch.dtype = torch.float64,
    device=None,
    cheb_degree: int = 2,
    power_iters: int = 10,
    coarse_method: str = "cholesky",
    ess_faces=("x0",),
    start_vectors: Sequence[torch.Tensor] | None = None,
    seed: int = 1234,
) -> GMGPreconditioner:
    """Build the paper's GMG preconditioner for the beam benchmark.

    ``start_vectors`` holds the power iteration's start vector of every
    smoothed level (levels 1..L-1, coarse -> fine), each of shape
    (nscalar, 3); without it each level draws its own from ``seed``."""
    device = resolve_device(device)
    spaces = hierarchy_spaces(coarse_mesh, n_h_refine, p_target)
    if start_vectors is not None and len(start_vectors) != len(spaces) - 1:
        raise ValueError(
            f"start_vectors has {len(start_vectors)} entries; the hierarchy "
            f"has {len(spaces) - 1} smoothed levels"
        )

    levels: list[Level] = []
    for i, sp in enumerate(spaces):
        op = ElasticityOperator(
            sp,
            assembly=assembly,
            materials=materials,
            dtype=dtype,
            device=device,
            ess_faces=ess_faces,
        )
        cop = op.constrained()
        smoother = None
        if i > 0:
            v0 = None
            if start_vectors is not None:
                v0 = torch.as_tensor(start_vectors[i - 1], dtype=dtype, device=device)
            smoother = ChebyshevSmoother.setup(
                cop,
                cop.diagonal(),
                degree=cheb_degree,
                power_iters=power_iters,
                v0=v0,
                seed=seed,
            )
        levels.append(
            Level(
                space=sp,
                operator=op,
                constrained=cop,
                smoother=smoother,
                ess_mask=op.ess_mask,
            )
        )

    transfers = [
        make_transfer(levels[i].space, levels[i + 1].space, dtype=dtype, device=device)
        for i in range(len(levels) - 1)
    ]
    coarse_solve = make_coarse_solver(levels[0].operator, method=coarse_method)
    return GMGPreconditioner(
        levels=levels, transfers=transfers, coarse_solve=coarse_solve
    )
