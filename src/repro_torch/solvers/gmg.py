"""Geometric multigrid preconditioner (paper Sec. 3).

Hierarchy: starting from the coarse mesh, ``n_h_refine`` uniform
refinements give levels 0..r at degree p_min = 1; p-refinements then
double the degree until the finest level reaches the target p
(appending p_target itself when it is not a power of two).  Every level
but the coarsest uses the requested assembly level; the coarsest runs
the fused operator unless the whole hierarchy is ``fa``
(:func:`~repro_torch.core.operators.fused_level`: the requested level if
it is fused, else ``paop_cuda`` on the card and ``paop`` on the CPU, as
the reference runs its ``paop`` there), so on the card no plain PAop
apply stays on the path.  Fine and intermediate levels smooth with
Chebyshev(k=2)-Jacobi; the coarsest level is solved per
:mod:`repro_torch.solvers.coarse`.

Scenario batching: passing ``materials`` as a *sequence* of scenario
entries builds one hierarchy whose operators, smoothers, transfers and
coarse solve all carry a leading scenario axis (S, nscalar, 3); the
V-cycle is shape-agnostic and preconditions every scenario in one pass.

Per-element ``(lam_e, mu_e)`` fields are given on the finest mesh; each
coarser h-level sees them averaged over its elements' fine descendants
(:func:`restrict_field`), as the batched solver's levels do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.operators import ElasticityOperator, fused_level
from repro_torch.device import resolve_device
from repro_torch.fem.mesh import HexMesh, fine_descendants
from repro_torch.fem.space import H1Space
from repro_torch.fem.transfer import Transfer, make_transfer
from repro_torch.solvers.chebyshev import ChebyshevSmoother
from repro_torch.solvers.coarse import make_coarse_solver

__all__ = [
    "restrict_field",
    "level_descendants",
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


def restrict_field(field: torch.Tensor, desc: torch.Tensor) -> torch.Tensor:
    """Average a per-element field (..., nelem_fine) over each coarse
    element's fine descendants ``desc`` (nelem_coarse, 2^k), as a pairwise
    halving tree: exact whenever all descendants of an element carry the
    same value, so a piecewise-constant field gives the equivalent
    attribute dict's fields bit for bit on every level."""
    g = field[..., desc]  # (..., nelem_coarse, 2^k)
    k = g.shape[-1]
    while g.shape[-1] > 1:
        g = g[..., 0::2] + g[..., 1::2]
    return g[..., 0] / k


def level_descendants(spaces: Sequence[H1Space], device) -> list[torch.Tensor | None]:
    """Each level's fine-descendant map onto the finest level's mesh, an
    int64 (nelem_level, 2^k) tensor on ``device`` for :func:`restrict_field`;
    None for levels on the fine mesh (the p-levels)."""
    fine_mesh = spaces[-1].mesh
    return [
        None
        if sp.nelem == fine_mesh.nelem
        else torch.as_tensor(
            fine_descendants(sp.mesh, fine_mesh), dtype=torch.int64, device=device
        )
        for sp in spaces
    ]


def _level_materials(materials, desc: torch.Tensor | None, nelem_fine: int):
    """``materials`` as a level with fine-descendant map ``desc`` sees
    them: per-element pairs (alone or as scenario entries) restricted from
    the fine mesh; dicts and the fine mesh's own materials unchanged."""
    if materials is None or isinstance(materials, dict) or desc is None:
        return materials

    def level(m):
        if isinstance(m, dict):
            return m
        pair = tuple(torch.as_tensor(f, dtype=torch.float64, device="cpu") for f in m)
        if any(f.shape != (nelem_fine,) for f in pair):
            raise ValueError(
                f"per-element material fields must be given on the finest mesh "
                f"({nelem_fine} elements), got {[tuple(f.shape) for f in pair]}"
            )
        return tuple(restrict_field(f, desc) for f in pair)

    if ElasticityOperator._is_field_pair(materials):
        return level(materials)
    return [level(m) for m in materials]


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
    smoothed level (levels 1..L-1, coarse -> fine), each of the
    per-scenario shape (nscalar, 3); without it each level draws its own
    from ``seed``."""
    device = resolve_device(device)
    spaces = hierarchy_spaces(coarse_mesh, n_h_refine, p_target)
    if start_vectors is not None and len(start_vectors) != len(spaces) - 1:
        raise ValueError(
            f"start_vectors has {len(start_vectors)} entries; the hierarchy "
            f"has {len(spaces) - 1} smoothed levels"
        )

    # Per-element fields are restricted on the host, once per level.
    descs = (
        [None] * len(spaces)
        if materials is None or isinstance(materials, dict)
        else level_descendants(spaces, "cpu")
    )
    levels: list[Level] = []
    for i, sp in enumerate(spaces):
        op = ElasticityOperator(
            sp,
            assembly=assembly if i > 0 else fused_level(assembly, device),
            materials=_level_materials(materials, descs[i], spaces[-1].nelem),
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
                batch_dims=0 if op.nbatch is None else 1,
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
