"""The batched solve service's request mix, for one discretization.

The reference's ``serve_solve`` CLI drives its service with a fixed,
deterministic workload: alternating material contrasts, traction
directions and magnitudes, and tolerances, with attribute dicts or
per-element coefficient fields (``--material-field``).  This module
holds the same mix in numpy, as the scenario lists that
:meth:`~repro_torch.solvers.batched.BatchedGMGSolver.solve` takes, so a
batched run on the port sends what a user of that CLI sends.

Usage:
    from repro_torch.launch.workload import make_workload
    mats, tractions, rel_tol = make_workload(8, 4, 1e-6)
    mats, tractions, rel_tol = make_workload(8, 4, 1e-6, "lognormal:0")
"""

from __future__ import annotations

import numpy as np

from repro_torch.fem.mesh import HexMesh, beam_hex

__all__ = ["make_material_field", "make_workload"]


def make_material_field(kind: str, coarse_mesh: HexMesh, refine: int, i: int):
    """Per-element ``(lam_e, mu_e)`` fields on the fine mesh for request
    ``i``.  ``kind`` is ``graded`` (stiffness ramps down along x from the
    clamped end), ``checkerboard`` (two-phase composite by element
    parity) or ``lognormal[:seed]`` (iid lognormal random medium).  A
    vocabulary of 4 variants per kind (``i % 4``) repeats materials
    across requests."""
    fine = coarse_mesh.refined(refine)
    nx, ny, nz = fine.shape
    e = np.arange(fine.nelem)
    ex, ey, ez = e % nx, (e // nx) % ny, e // (nx * ny)
    v = i % 4
    if kind == "graded":
        t = (ex + 0.5) / nx  # 0 at the clamped x=0 face
        lam = (50.0 + 5.0 * v) * (1.0 - t) + 1.0
        mu = 0.8 * lam
    elif kind == "checkerboard":
        hard = (ex + ey + ez) % 2 == 0
        lam = np.where(hard, 50.0 + 5.0 * v, 1.0 + 0.2 * v)
        mu = np.where(hard, 45.0 + 5.0 * v, 1.0)
    elif kind.startswith("lognormal"):
        seed = int(kind.split(":", 1)[1]) if ":" in kind else 0
        rng = np.random.default_rng(seed * 1000 + v)
        lam = np.exp(rng.normal(np.log(10.0), 0.6, fine.nelem))
        mu = np.exp(rng.normal(np.log(8.0), 0.6, fine.nelem))
    else:
        raise ValueError(
            f"unknown material field {kind!r} (expected graded, "
            f"checkerboard or lognormal[:seed])"
        )
    return np.asarray(lam, dtype=np.float64), np.asarray(mu, np.float64)


def make_workload(
    n_requests: int,
    refine: int,
    base_tol: float,
    material_field: str | None = None,
) -> tuple[list, np.ndarray, np.ndarray]:
    """Requests ``0 .. n_requests-1`` of the mixed workload on
    ``beam_hex().refined(refine)``, as ``(materials, tractions, rel_tol)``:
    a list of attribute dicts (stiff 50 + 10 (i % 3), soft 1 + 0.5 (i % 2))
    or, with ``material_field`` set, of :func:`make_material_field` pairs;
    tractions (0, 2e-3 for odd i else 0, -1e-2 (1 + 0.25 (i % 4))), shape
    (n, 3); rel_tol ``base_tol`` for odd i and ``base_tol * 1e-2`` for
    even i, shape (n,)."""
    materials, tractions, rel_tol = [], [], []
    for i in range(n_requests):
        if material_field is None:
            stiff = 50.0 + 10.0 * (i % 3)
            soft = 1.0 + 0.5 * (i % 2)
            materials.append({1: (stiff, stiff), 2: (soft, soft)})
        else:
            materials.append(make_material_field(material_field, beam_hex(), refine, i))
        tractions.append((0.0, 2e-3 if i % 2 else 0.0, -1e-2 * (1.0 + 0.25 * (i % 4))))
        rel_tol.append(base_tol if i % 2 else base_tol * 1e-2)
    return materials, np.array(tractions), np.array(rel_tol)
