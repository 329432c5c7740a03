"""Batched multi-scenario GMG-PCG: many parameterized elasticity solves
at once on the card, resumable in bounded chunks.

* :func:`bpcg` — PCG over a leading scenario axis.  Per-scenario
  convergence is tracked with an active mask: converged scenarios'
  ``x``/``r``/``d`` are frozen (their step sizes are forced to zero and
  direction updates gated), the loop runs until every scenario converges
  or hits ``maxiter``, and per-scenario iteration counts are reported.

* the resumable step program — ``bpcg`` is split into :func:`bpcg_init`
  (build a :class:`BpcgState`) and :func:`bpcg_chunk` (advance all rows by
  a bounded number of iterations).  Frozen rows never change, so chunks of
  ``k1`` then ``k2`` iterations give exactly the state of one
  uninterrupted ``k1 + k2`` run; :func:`merge_states` resets just the
  refilled rows and leaves the others bitwise.

* :class:`BatchedGMGSolver` — the solve for one discretization
  ``(coarse_mesh, n_h_refine, p)``.  Geometry (spaces, transfers,
  fine-descendant maps, basis tables, traction pattern) is built once at
  construction; materials, tractions and tolerances are arguments of each
  call.  ``prepare`` folds (new) per-scenario materials into the
  operators' per-row weighted fields and recomputes the derived data
  (smoother diagonals and lambda_max, the coarse Cholesky factor) for
  exactly the reset rows; ``run_chunk`` rebuilds the hierarchy from that
  ``prep`` dict (no power iterations, no refactorization) and advances
  the state by ``k`` iterations; ``solve`` runs the same machinery to
  completion in one call.  ``take_rows`` (re-bucketing) and
  ``copy_prep_rows`` (prep reuse between rows of equal materials) are
  the continuous solve service's row moves.

The scenario axis is threaded through ``ChebyshevSmoother``,
``GMGPreconditioner`` and ``Transfer``; operators fold it into the
element axis, so the PAop kernel runs unchanged on S * nelem elements.
Every reduction keeps a fixed order (the scatter sums over its incidence
table, the dot products per row), so a batch repeats bitwise on the same
device.

The loop tests ``active.any()`` on the host once per iteration: one
host sync per iteration, as in :func:`repro_torch.solvers.cg.pcg`.

Multi-device: ``BatchedGMGSolver(..., mesh=...)`` (a sequence of devices,
repeats allowed, or an int: the first n cards, or n virtual CPU devices
with ``device="cpu"``; see :mod:`repro_torch.distributed.sharding`)
splits the scenario axis into one contiguous row block per mesh device.
The state, the prep and the (S,) vectors a call returns are
:class:`~repro_torch.distributed.sharding.ScenarioBlocks`; each device
holds its own hierarchy (one per distinct device) and runs the
single-device program on its rows, so the PAop kernel launches once per
shard and apply.  The shards step in lockstep
(:func:`bpcg_chunk_shards`): each iteration queues every shard's work,
gathers the (S/n,) active flags onto the first device and reads them on
the host once, so a sharded chunk makes the host syncs of an unsharded
one.  Rows never couple, so iterations, flags and solutions do not depend
on the mesh; ``solve`` pads S to a multiple of the device count with
born-converged rows and slices them off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.geometry import (
    check_material_dict,
    check_material_fields,
    material_fields,
)
from repro_torch.core.operators import DEFER_MATERIALS, ElasticityOperator, fused_level
from repro_torch.core.precision import PrecisionPolicy, resolve_precision
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    ScenarioBlocks,
    device_put_scenario,
    gather_scenario,
    join_shards,
    normalize_scenario_mesh,
    shard_of,
    tree_to,
)
from repro_torch.fem.mesh import HexMesh
from repro_torch.fem.space import H1Space
from repro_torch.fem.transfer import make_transfer
from repro_torch.solvers.chebyshev import ChebyshevSmoother, _expand, start_vector
from repro_torch.solvers.coarse import cholesky_solver, probe_coarse_matrix
from repro_torch.solvers.gmg import (
    GMGPreconditioner,
    Level,
    hierarchy_spaces,
    level_descendants,
    restrict_field,
)

__all__ = [
    "bpcg",
    "bpcg_init",
    "bpcg_chunk",
    "bpcg_chunk_shards",
    "bpcg_result",
    "true_residual_audit",
    "merge_states",
    "BpcgState",
    "BPCGResult",
    "BatchedGMGSolver",
]

_NUMPY_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _numpy(a) -> np.ndarray:
    """A tensor, or row blocks gathered, as a host numpy array; bfloat16
    (which numpy lacks) as its uint16 bit patterns."""
    t = a.cpu() if isinstance(a, ScenarioBlocks) else a.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_numpy` for a leaf of ``dtype``: bfloat16 from
    its 16-bit patterns (any 2-byte array), bitwise; other arrays as they
    are."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


@dataclasses.dataclass
class BPCGResult:
    x: torch.Tensor  # (S, ...) solutions
    iterations: torch.Tensor  # (S,) int32 per-scenario counts
    converged: torch.Tensor  # (S,) bool
    final_norm: torch.Tensor  # (S,) sqrt((B r, r)) at exit
    initial_norm: torch.Tensor  # (S,)
    stalled: torch.Tensor  # (S,) bool — stagnation detected (reduced precision)
    fallback: torch.Tensor  # (S,) bool — row was re-solved on the f64 path


@dataclasses.dataclass
class BpcgState:
    """Resumable PCG state, one row per batch slot: everything an
    iteration needs, so ``run_chunk`` can hand the state back to the
    caller between chunks and resume bit-identically."""

    x: torch.Tensor  # (S, ...) iterates
    r: torch.Tensor  # (S, ...) residuals
    z: torch.Tensor  # (S, ...) preconditioned residuals
    d: torch.Tensor  # (S, ...) search directions
    nom: torch.Tensor  # (S,) current (B r, r)
    nom0: torch.Tensor  # (S,) (B r, r) at the row's (re)start
    threshold: torch.Tensor  # (S,) per-row stopping value for nom
    iters: torch.Tensor  # (S,) int32 iterations since the row's (re)start
    active: torch.Tensor  # (S,) bool — still iterating
    best: torch.Tensor  # (S,) lowest nom seen since the row's (re)start
    stall: torch.Tensor  # (S,) int32 consecutive low-progress iterations
    stalled: torch.Tensor  # (S,) bool — sticky stagnation flag (see bpcg_chunk)


def _dots(a, b):
    """Per-scenario inner products: contract everything but axis 0."""
    return torch.sum(a.reshape(a.shape[0], -1) * b.reshape(b.shape[0], -1), dim=1)


# (S,) coefficients broadcast against (S, ...) vectors with the same
# right-pad rule the batched Chebyshev smoother uses.
_col = _expand


def _identity(r):
    return r


def _per_row(v, s: int, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a scalar, or (S,) values) as an (S,) tensor like ``like``.
    A Python scalar is filled on the device: no host-to-device copy, which
    the card counts as a host sync."""
    if isinstance(v, torch.Tensor) or np.ndim(v):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device).expand(s)
    return torch.full((s,), float(v), dtype=like.dtype, device=like.device)


def _host_any(flags: list[torch.Tensor]) -> bool:
    """Whether any of the per-shard flag tensors holds True, read on the
    host once: the flags are gathered onto the first one's device first."""
    if len(flags) == 1:
        return bool(flags[0].any())
    dev = flags[0].device
    return bool(torch.cat([f.reshape(-1).to(dev, non_blocking=True) for f in flags]).any())


def bpcg_init(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    *,
    x0=None,
    rel_tol=1e-6,
    abs_tol=0.0,
    flexible: bool = False,
) -> BpcgState:
    """Build the initial :class:`BpcgState` for ``A x = b``.

    MFEM-style thresholds, per scenario: a row stops when
    ``nom <= max(nom0 * rel_tol^2, abs_tol^2)``; ``rel_tol``/``abs_tol``
    may be scalars or (S,) arrays.  A row with a zero RHS is born
    converged (0 iterations), which is also what makes padding rows free.
    With ``flexible`` (an indefinite preconditioner, see :func:`bpcg_chunk`)
    a row whose first (z, r) is negative starts stalled and inactive."""
    M = M or _identity
    s = b.shape[0]
    if x0 is None:
        x = torch.zeros_like(b)
        r = b  # A is linear: A(0) == 0 exactly
    else:
        x = x0
        r = b - A(x)
    z = M(r)
    nom0 = _dots(z, r)
    rel = _per_row(rel_tol, s, nom0)
    ab = _per_row(abs_tol, s, nom0)
    threshold = torch.maximum(nom0 * rel**2, ab**2)
    zeros = torch.zeros((s,), dtype=torch.int32, device=b.device)
    broke = (nom0 < 0) if flexible else torch.zeros((s,), dtype=torch.bool, device=b.device)
    return BpcgState(
        x=x,
        r=r,
        z=z,
        d=z,
        nom=nom0,
        nom0=nom0,
        threshold=threshold,
        iters=zeros,
        active=nom0 > threshold,
        best=nom0,
        stall=zeros,
        stalled=broke,
    )


def bpcg_chunk(
    A: Callable,
    state: BpcgState,
    M: Callable | None = None,
    *,
    k_iters: int | None = None,
    maxiter: int = 5000,
    stall_iters: int = 0,
    stall_rtol: float = 0.99,
    flexible: bool = False,
) -> BpcgState:
    """Advance every active row by up to ``k_iters`` PCG iterations
    (to convergence or ``maxiter`` when ``k_iters`` is None).
    ``flexible`` takes the Polak-Ribiere direction update, as
    :func:`repro_torch.solvers.cg.pcg` does.

    Chunked resumption is exact: inactive rows are frozen (alpha forced
    to 0, direction updates gated), so ``chunk(k1)`` followed by
    ``chunk(k2)`` yields the same state as one ``chunk(k1 + k2)`` call.

    Stagnation detection (the reduced-precision safety net): with
    ``stall_iters > 0``, a row that goes ``stall_iters`` consecutive
    iterations without reducing its best-seen ``nom`` by at least a
    factor ``stall_rtol`` is flagged ``stalled`` (sticky) and deactivated:
    it has hit the precision floor of the arithmetic.  The default
    ``stall_iters = 0`` leaves the detector out of the loop entirely, so
    the f64 path does no extra arithmetic.  With ``flexible`` a row whose
    (z, r) turns negative is flagged ``stalled`` and deactivated too
    (see :func:`repro_torch.solvers.cg.pcg`)."""
    return bpcg_chunk_shards(
        [(A, M)], [state], k_iters=k_iters, maxiter=maxiter,
        stall_iters=stall_iters, stall_rtol=stall_rtol, flexible=flexible,
    )[0]


def bpcg_chunk_shards(
    ops: Sequence[tuple[Callable, Callable | None]],
    states: Sequence[BpcgState],
    *,
    k_iters: int | None = None,
    maxiter: int = 5000,
    stall_iters: int = 0,
    stall_rtol: float = 0.99,
    flexible: bool = False,
) -> list[BpcgState]:
    """:func:`bpcg_chunk` over row blocks that never couple, each with its
    own operator and preconditioner ``ops[k] = (A, M)`` (one block per
    device of a scenario mesh), in lockstep: an iteration steps every
    block, then reads whether any row of any block is still active on the
    host once, from the blocks' flags gathered onto the first block's
    device.  A block whose rows are all inactive steps frozen, as inactive
    rows do within a block."""
    states, step = list(states), 0
    while (k_iters is None or step < k_iters) and _host_any([st.active for st in states]):
        states = [
            _bpcg_step(A, M or _identity, st, maxiter, stall_iters, stall_rtol, flexible)
            for (A, M), st in zip(ops, states)
        ]
        step += 1
    return states


def _bpcg_step(A, M, st: BpcgState, maxiter, stall_iters, stall_rtol, flexible) -> BpcgState:
    """One masked PCG iteration of every row of ``st`` (see
    :func:`bpcg_chunk`)."""
    active = st.active
    ad = A(st.d)
    den = _dots(st.d, ad)
    # Inactive rows get alpha = 0 (frozen); den == 0 cannot occur for
    # an active SPD row (d != 0 there) but is guarded so one bad or
    # retired scenario can never NaN the rest of the batch.
    ok = active & (den > 0)
    alpha = torch.where(ok, st.nom / torch.where(den == 0, 1.0, den), 0.0)
    x = st.x + _col(alpha, st.x.ndim) * st.d
    r = st.r - _col(alpha, st.r.ndim) * ad
    z = M(r)
    betanom = _dots(z, r)
    num = betanom - _dots(z, st.r) if flexible else betanom
    beta = torch.where(ok, num / torch.where(st.nom == 0, 1.0, st.nom), 0.0)
    d = torch.where(
        _col(active, st.d.ndim), z + _col(beta, st.d.ndim) * st.d, st.d
    )
    # Count only real steps (ok), matching scalar pcg: an aborted
    # degenerate direction (den <= 0) takes no step and adds none.
    iters = st.iters + ok.to(torch.int32)
    if flexible:
        # A negative (z, r) is a breakdown of the indefinite
        # preconditioner: the row keeps its last nom (unconverged) and is
        # flagged stalled, which routes it to the f64 fallback.
        broke = ok & (betanom < 0)
        nom = torch.where(active & ~broke, betanom, st.nom)
        active = ok & ~broke & (nom > st.threshold) & (iters < maxiter)
        stalled = st.stalled | broke
    else:
        nom = torch.where(active, betanom, st.nom)
        active = ok & (nom > st.threshold) & (iters < maxiter)
        stalled = st.stalled
    new = dataclasses.replace(
        st, x=x, r=r, z=z, d=d, nom=nom, iters=iters, active=active, stalled=stalled
    )
    if stall_iters > 0:
        # Progress = the best-seen nom dropped by >= (1 - rtol); the
        # best so far (not the last step), so an oscillating residual
        # does not reset the counter on every upswing.
        improved = betanom < st.best * stall_rtol
        stall = torch.where(ok, torch.where(improved, 0, st.stall + 1), st.stall)
        best = torch.where(ok, torch.minimum(st.best, betanom), st.best)
        hit = active & (stall >= stall_iters)
        new = dataclasses.replace(
            new, active=active & ~hit, best=best, stall=stall,
            stalled=new.stalled | hit,
        )
    return new


def merge_states(reset_mask, fresh: BpcgState, old: BpcgState) -> BpcgState:
    """Per-row state merge: rows selected by ``reset_mask`` (S,) take
    ``fresh`` (a just-initialized state for their new RHS/tolerance), the
    rest keep ``old`` bitwise."""
    mask = torch.as_tensor(reset_mask, dtype=torch.bool, device=old.x.device)
    return BpcgState(
        **{
            f.name: torch.where(
                _col(mask, getattr(fresh, f.name).ndim),
                getattr(fresh, f.name),
                getattr(old, f.name),
            )
            for f in dataclasses.fields(BpcgState)
        }
    )


def true_residual_audit(
    A: Callable, M: Callable, b, state: BpcgState, slack: float = 4.0
) -> BpcgState:
    """The reduced-precision honesty check: CG's recursively updated
    residual drifts from ``b - A x`` once rounding dominates, so its
    ``nom`` can sail below any threshold while the true residual sits at
    the arithmetic's floor.  Recompute the true preconditioned norm for
    rows claiming convergence; a row whose true ``nom`` exceeds its
    threshold by more than ``slack`` is marked ``stalled`` (sticky) and
    gets the true norm as its exit ``nom``, so :func:`bpcg_result` reports
    it unconverged and ``solve`` routes it to the f64 fallback.  Rows
    passing the audit keep their state bitwise.  Not run on the f64 path."""
    claimed = ~state.active & (state.nom <= state.threshold) & ~state.stalled
    rt = b - A(state.x)
    nomt = _dots(M(rt), rt)
    # A negative nomt only an indefinite (bfloat16) preconditioner gives.
    lying = claimed & ((nomt > state.threshold * slack) | (nomt < 0))
    return dataclasses.replace(
        state,
        nom=torch.where(lying, nomt, state.nom),
        stalled=state.stalled | lying,
    )


def _merge_fallback_rows(res: BPCGResult, sub: BPCGResult, rows) -> BPCGResult:
    """Merge an f64 re-solve of ``rows`` into a reduced-precision result.
    The merged result is f64 (a fallback row's extra accuracy cannot ride
    an f32 vector); ``iterations`` accumulates so the reported count is
    the total cost, ``fallback`` marks the re-solved rows, and ``stalled``
    keeps recording that the reduced pass flagged them."""
    rows = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=res.x.device)

    def put(a, v, dtype=None):
        out = a.to(dtype or a.dtype, copy=True)
        out[rows] = v.to(out.dtype)
        return out

    fallback = torch.zeros_like(res.stalled)
    fallback[rows] = True
    return BPCGResult(
        x=put(res.x, sub.x, torch.float64),
        iterations=put(res.iterations, res.iterations[rows] + sub.iterations),
        converged=put(res.converged, sub.converged),
        final_norm=put(res.final_norm, sub.final_norm, torch.float64),
        initial_norm=put(res.initial_norm, sub.initial_norm, torch.float64),
        stalled=res.stalled,
        fallback=fallback,
    )


def bpcg_result(state: BpcgState) -> BPCGResult:
    """The result of a state; a sharded state is gathered onto its first
    device."""
    state = gather_scenario(state)
    return BPCGResult(
        x=state.x,
        iterations=state.iters,
        converged=(state.nom <= state.threshold) & ~(state.stalled & (state.nom < 0)),
        final_norm=torch.sqrt(torch.abs(state.nom)),
        initial_norm=torch.sqrt(torch.abs(state.nom0)),
        stalled=state.stalled,
        fallback=torch.zeros_like(state.stalled),
    )


def bpcg(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    *,
    x0=None,
    rel_tol=1e-6,
    abs_tol=0.0,
    maxiter: int = 5000,
    stall_iters: int = 0,
    stall_rtol: float = 0.99,
    flexible: bool = False,
) -> BPCGResult:
    """MFEM-style PCG over a leading scenario axis with masked convergence.

    ``A`` and ``M`` map (S, ...) batches to (S, ...) batches with no
    cross-scenario coupling; ``rel_tol``/``abs_tol`` may be scalars or
    (S,) tensors.  The resumable step program run in one uninterrupted
    chunk (see :func:`bpcg_init` / :func:`bpcg_chunk`)."""
    state = bpcg_init(A, b, M, x0=x0, rel_tol=rel_tol, abs_tol=abs_tol, flexible=flexible)
    state = bpcg_chunk(
        A, state, M, k_iters=None, maxiter=maxiter,
        stall_iters=stall_iters, stall_rtol=stall_rtol, flexible=flexible,
    )
    return bpcg_result(state)


class BatchedGMGSolver:
    """Multi-scenario GMG-PCG solves for one discretization, on the card by
    default (``device="cpu"`` runs the plain PyTorch version).

    Construction builds everything material-independent for the beam
    benchmark family: the mesh/degree hierarchy, transfer operators,
    per-level fine-descendant maps, the boundary traction pattern and the
    power iterations' start vectors.  ``solve`` takes per-scenario
    materials (attribute dicts and/or per-element (lam_e, mu_e) arrays,
    see :meth:`pack_materials`), traction vectors and tolerances and runs
    to completion; ``prepare`` + ``run_chunk`` expose the same solve as a
    resumable step program for continuous batching.

    ``assembly`` is any matrix-free level of
    :data:`~repro_torch.core.operators.ASSEMBLY_LEVELS` (``fa`` raises);
    the coarsest level runs the fused operator, as in
    :func:`~repro_torch.solvers.gmg.build_hierarchy`.

    Precision: ``precision`` names a
    :class:`~repro_torch.core.precision.PrecisionPolicy` (``"f64"``,
    ``"f32"``, ``"mixed"``, ``"mixed-bf16"`` or a policy object).  The
    outer Krylov loop runs in ``policy.solve_dtype`` (``self.dtype``), the
    V-cycle in ``policy.precond_dtype``, the coarse probe/Cholesky in
    ``policy.coarse_dtype``: the coarse matrix is probed through a
    coarse-dtype copy of the coarsest operator on the precond-dtype
    weighted fields upcast (the reference probes at the precond dtype and
    casts, which under ``mixed-bf16`` gives a NaN factor).  When the solve and V-cycle dtypes differ the
    fine level keeps a second, solve-dtype copy of its weighted fields
    (``prep["lam_w_solve"]``/``prep["mu_w_solve"]``).  Reduced policies
    run with the stagnation detector on, and ``solve`` re-solves any
    stalled rows on a lazily built f64 twin (``fallback`` marks them).

    ``start_vectors`` holds the power iteration's start vector of every
    smoothed level (coarse -> fine), each of the per-scenario shape
    (nscalar, 3) and broadcast over the batch; without it each level
    draws one from a generator seeded with 1234, as
    :func:`~repro_torch.solvers.gmg.build_hierarchy` does.

    ``mesh`` shards the scenario axis over a device list (see the module
    docstring); ``device`` then only resolves an int mesh, and
    ``self.device`` is the mesh's first device, where results gather.
    """

    def __init__(
        self,
        coarse_mesh: HexMesh,
        n_h_refine: int,
        p_target: int,
        *,
        assembly: str = "paop_cuda",
        precision: str | PrecisionPolicy | None = None,
        device=None,
        start_vectors: Sequence[torch.Tensor] | None = None,
        cheb_degree: int = 2,
        power_iters: int = 10,
        ess_faces=("x0",),
        traction_face: str = "x1",
        maxiter: int = 200,
        stall_iters: int = 20,
        stall_rtol: float = 0.99,
        mesh=None,
    ):
        if assembly == "fa":
            raise ValueError("batched solves are matrix-free ('fa' unsupported)")
        self.coarse_mesh = coarse_mesh
        self.n_h_refine = n_h_refine
        self.p_target = p_target
        self.assembly = assembly
        self.mesh, self.n_shards = normalize_scenario_mesh(mesh, device)
        self.device = self.mesh[0] if self.mesh is not None else resolve_device(device)
        self.precision = resolve_precision(precision)
        self.dtype = self.precision.solve_dtype
        self.precond_dtype = self.precision.precond_dtype
        self.coarse_dtype = self.precision.coarse_dtype
        self.cheb_degree = cheb_degree
        self.power_iters = power_iters
        self.maxiter = maxiter
        # Stagnation detection is armed only for reduced policies: the
        # f64 loop does no detector arithmetic at all.
        self.stall_iters = stall_iters if self.precision.reduced else 0
        self.stall_rtol = stall_rtol
        # A bfloat16 V-cycle is no fixed linear map: flexible PCG.
        self.flexible = self.precond_dtype == torch.bfloat16
        self._f64_twin: BatchedGMGSolver | None = None
        self._ess_faces = ess_faces
        self._traction_face = traction_face
        self._start_vectors_arg = start_vectors

        spaces = hierarchy_spaces(coarse_mesh, n_h_refine, p_target)
        self.spaces = spaces
        if start_vectors is not None and len(start_vectors) != len(spaces) - 1:
            raise ValueError(
                f"start_vectors has {len(start_vectors)} entries; the hierarchy "
                f"has {len(spaces) - 1} smoothed levels"
            )
        # Attribute vocabulary: for validating attribute-dict scenarios.
        self.attr_values: tuple[int, ...] = tuple(
            int(a) for a in np.unique(coarse_mesh.attributes())
        )

        # Scenario materials travel as (S, nelem_fine) per-element fields.
        # Each coarser h-level sees the fine field through its
        # fine-descendant map (an exact power-of-two tree average, see
        # _restrict_field); p-levels share the fine mesh (map None).
        self._split_fine = self.dtype != self.precond_dtype
        # The coarsest level runs the fused operator (the reference's level
        # rule, see solvers/gmg.py), and so does a one-level hierarchy's
        # fine solve-dtype twin.
        coarse = fused_level(assembly, self.device)
        self._base_ops = [
            self._carrier(sp, self.precond_dtype, assembly if i > 0 else coarse)
            for i, sp in enumerate(spaces)
        ]
        # The coarse probe's operator: the coarsest carrier itself, or one at
        # the coarse dtype when that differs from the V-cycle's.
        self._coarse_base = (
            self._base_ops[0]
            if self.coarse_dtype == self.precond_dtype
            else self._carrier(spaces[0], self.coarse_dtype, coarse)
        )
        self._desc_idx = level_descendants(spaces, self.device)
        self._fine_base_solve = (
            self._carrier(spaces[-1], self.dtype, assembly if len(spaces) > 1 else coarse)
            if self._split_fine
            else None
        )
        self.transfers = [
            make_transfer(
                spaces[i], spaces[i + 1], dtype=self.precond_dtype, device=self.device
            )
            for i in range(len(spaces) - 1)
        ]
        self._start_vectors = [
            start_vector((sp.nscalar, 3), self.precond_dtype, self.device)
            if start_vectors is None
            else torch.as_tensor(
                start_vectors[i], dtype=self.precond_dtype, device=self.device
            )
            for i, sp in enumerate(spaces[1:])
        ]
        # traction_rhs is linear in the traction vector and separable:
        # F = pattern (x) t, so probing with t = e_x yields the pattern.
        fine = spaces[-1]
        self._traction_pattern = torch.as_tensor(
            fine.traction_rhs(traction_face, (1.0, 0.0, 0.0))[:, 0],
            dtype=self.dtype, device=self.device,
        )
        self._fine_ess = self._base_ops[-1].ess_mask
        # The program of each mesh device: this solver on its own device,
        # one unsharded twin on every other distinct device.
        twins = {}
        for d in self.mesh or ():
            if d != self.device and d not in twins:
                twins[d] = BatchedGMGSolver(
                    coarse_mesh, n_h_refine, p_target, assembly=assembly,
                    precision=self.precision, device=d, start_vectors=start_vectors,
                    cheb_degree=cheb_degree, power_iters=power_iters,
                    ess_faces=ess_faces, traction_face=traction_face,
                    maxiter=maxiter, stall_iters=stall_iters, stall_rtol=stall_rtol,
                )
        self._programs = tuple(twins.get(d, self) for d in self.mesh or (self.device,))

    def _carrier(self, space: H1Space, dtype, assembly: str) -> ElasticityOperator:
        """A geometry/tables carrier: every call binds per-scenario fields."""
        return ElasticityOperator(
            space, assembly=assembly, materials=DEFER_MATERIALS, dtype=dtype,
            device=self.device, ess_faces=self._ess_faces,
        )

    @property
    def fine_space(self) -> H1Space:
        return self.spaces[-1]

    def pad_batch(self, n: int) -> int:
        """Rows a batch of ``n`` scenarios must be padded to so the
        scenario axis divides the device mesh (``n`` unsharded)."""
        m = self.n_shards
        return -(-n // m) * m

    def pad_scenarios(self, materials, tractions, rel_tol, n: int | None = None):
        """Pad a scenario batch to ``n`` rows (default :meth:`pad_batch`)
        with born-converged padding rows: the first scenario's materials
        (keeps the batched operators SPD) and a zero traction, so b == 0
        makes them free (0 iterations).  Returns ``(materials, tractions,
        rel_tols, n_real)`` with rel_tols broadcast to a per-row array."""
        s = len(materials)
        if n is None:
            n = self.pad_batch(s)
        # The solver's dtype: a non-f64 solver's arguments are not promoted.
        sdt = _NUMPY_DTYPE[self.dtype]
        tractions = np.asarray(tractions, dtype=sdt)
        rel = np.broadcast_to(np.asarray(rel_tol, dtype=sdt), (s,)).copy()
        if n > s:
            materials = list(materials) + [materials[0]] * (n - s)
            tractions = np.concatenate(
                [tractions, np.zeros((n - s, 3), dtype=sdt)], axis=0
            )
            rel = np.concatenate([rel, np.full((n - s,), 1e-6, dtype=sdt)])
        return materials, tractions, rel, s

    # -- prep ------------------------------------------------------------------
    # prep carries every per-scenario derived quantity the step program
    # needs, as plain tensors: the operators' weighted material fields per
    # level, the smoother inverse diagonals and lambda_max per smoothed
    # level, and the coarse Cholesky factor.  ``prepare`` produces it and
    # ``run_chunk`` consumes it, so chunks pay neither power iterations nor
    # refactorization.

    # -- sharding ---------------------------------------------------------------
    def _check_mesh(self, s: int, what: str) -> None:
        if s % self.n_shards:
            raise ValueError(
                f"{what}: batch size {s} does not divide the "
                f"{self.n_shards}-device scenario mesh; pad to "
                f"pad_batch({s}) = {self.pad_batch(s)} born-converged rows"
            )

    def _put(self, tree):
        """Every tensor of ``tree`` on this solver's device, or split into
        row blocks over the mesh."""
        if self.mesh is None:
            return self._local(tree)
        return device_put_scenario(tree, self.mesh)

    def _local(self, tree):
        """Every tensor of ``tree`` gathered onto this solver's device."""
        return tree_to(tree, self.device)

    def _shards(self, tree) -> list:
        """Per-program views of ``tree``: block k of every row-blocked
        leaf for the program of mesh device k."""
        if self.mesh is None:
            return [tree]
        tree = device_put_scenario(tree, self.mesh)
        return [shard_of(tree, k) for k in range(self.n_shards)]

    def _join(self, parts: list):
        return parts[0] if self.mesh is None else join_shards(parts)

    def empty_prep(self, s: int) -> dict:
        """Zero-filled prep of the right shapes for an S-row batch (split
        over the mesh when sharded).  Only meaningful as the ``prep``
        argument of a ``prepare`` call whose reset mask covers every row
        that will ever be read."""
        self._check_mesh(s, "empty_prep")
        return self._join([
            prog._empty_prep(s // self.n_shards) for prog in self._programs
        ])

    def _empty_prep(self, s: int) -> dict:
        pdt, dev = self.precond_dtype, self.device
        lam_w, mu_w, dinv, lmax = [], [], [], []
        for i, (base, sp) in enumerate(zip(self._base_ops, self.spaces)):
            shape = (s * sp.nelem,) + base.w_detj.shape
            lam_w.append(torch.zeros(shape, dtype=pdt, device=dev))
            mu_w.append(torch.zeros(shape, dtype=pdt, device=dev))
            if i > 0:
                dinv.append(torch.zeros((s, sp.nscalar, 3), dtype=pdt, device=dev))
                lmax.append(torch.zeros((s,), dtype=pdt, device=dev))
        n0 = self.spaces[0].nscalar * 3
        prep = {
            "lam_w": tuple(lam_w),
            "mu_w": tuple(mu_w),
            "dinv": tuple(dinv),
            "lmax": tuple(lmax),
            "chol": torch.zeros((s, n0, n0), dtype=self.coarse_dtype, device=dev),
        }
        if self._split_fine:
            shape = (s * self.fine_space.nelem,) + self._fine_base_solve.w_detj.shape
            prep["lam_w_solve"] = torch.zeros(shape, dtype=self.dtype, device=dev)
            prep["mu_w_solve"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        return prep

    def empty_state(self, s: int) -> BpcgState:
        """All-rows-retired state of the right shapes for an S-row batch
        (every row must be reset before its first chunk; split over the
        mesh when sharded)."""
        self._check_mesh(s, "empty_state")
        return self._join([
            prog._empty_state(s // self.n_shards) for prog in self._programs
        ])

    def _empty_state(self, s: int) -> BpcgState:
        dev = self.device
        vec = torch.zeros((s, self.fine_space.nscalar, 3), dtype=self.dtype, device=dev)
        row = torch.zeros((s,), dtype=self.dtype, device=dev)
        count = torch.zeros((s,), dtype=torch.int32, device=dev)
        flag = torch.zeros((s,), dtype=torch.bool, device=dev)
        return BpcgState(
            x=vec, r=vec, z=vec, d=vec, nom=row, nom0=row, threshold=row,
            iters=count, active=flag, best=row, stall=count, stalled=flag,
        )

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)

    def _prep_map(self, prep: dict, per_row: Callable) -> dict:
        """Apply ``per_row`` to every prep tensor viewed with the scenario
        axis leading (the folded weighted fields unfolded per level), and
        fold the results back."""
        def folded(w, ne):
            tail = tuple(w.shape[1:])
            return per_row(w.reshape((w.shape[0] // ne, ne) + tail)).reshape((-1,) + tail)

        out = {
            "lam_w": tuple(folded(w, sp.nelem) for w, sp in zip(prep["lam_w"], self.spaces)),
            "mu_w": tuple(folded(w, sp.nelem) for w, sp in zip(prep["mu_w"], self.spaces)),
            "dinv": tuple(per_row(d) for d in prep["dinv"]),
            "lmax": tuple(per_row(m) for m in prep["lmax"]),
            "chol": per_row(prep["chol"]),
        }
        if self._split_fine:
            ne = self.fine_space.nelem
            out["lam_w_solve"] = folded(prep["lam_w_solve"], ne)
            out["mu_w_solve"] = folded(prep["mu_w_solve"], ne)
        return out

    def take_rows(self, state: BpcgState, prep: dict, rows) -> tuple[BpcgState, dict]:
        """Gather batch rows (re-bucketing): returns ``(state, prep)`` whose
        row i is the old row ``rows[i]``, bitwise.  ``rows`` may repeat
        indices (placeholder rows that the caller is about to reset) and
        may be shorter or longer than the old batch.  The inputs may be
        laid out anyhow (host tensors of ``state_from_host(place=False)``
        too): they are gathered onto this solver's device, and the result
        is split over the mesh (a re-bucketing changes which device owns
        which row)."""
        self._check_mesh(len(rows), "take_rows")
        state, prep = self._local((state, prep))
        idx = self._rows(rows)
        new_state = BpcgState(**{
            f.name: getattr(state, f.name).index_select(0, idx)
            for f in dataclasses.fields(BpcgState)
        })
        new_prep = self._prep_map(prep, lambda a: a.index_select(0, idx))
        return self._put(new_state), self._put(new_prep)

    def copy_prep_rows(self, prep: dict, src, dst) -> dict:
        """Duplicate prepared batch rows: row ``dst[i]`` takes row
        ``src[i]``'s derived data (weighted fields, smoother dinv/lmax,
        coarse factor) bitwise.  Every source is gathered before any
        destination is written, so a row may donate its prep while it is
        overwritten itself.  Prep depends only on a row's materials, so a
        refilled slot whose materials match a prepared row skips
        ``prepare``.  The input prep is left unchanged."""
        s_idx, d_idx = self._rows(src), self._rows(dst)
        return self._put(self._prep_map(
            self._local(prep),
            lambda a: a.index_copy(0, d_idx, a.index_select(0, s_idx)),
        ))

    # -- host (de)serialization ----------------------------------------------
    # The checkpoint contract of fault-tolerant serving
    # (repro_torch.serve.recovery): a resumable (state, prep) pair
    # round-trips through flat {name: host numpy array} dicts BITWISE, so a
    # restored flight that re-enters run_chunk finishes with the solutions
    # and iteration counts of the uninterrupted run.  The names are the
    # reference's: BpcgState field names for the state; ``lam_w{i}``/
    # ``mu_w{i}`` per hierarchy level, ``dinv{i}``/``lmax{i}`` per smoothed
    # level, ``chol``, and (when the solve and V-cycle dtypes differ) the
    # ``lam_w_solve``/``mu_w_solve`` fine-level twins for the prep.

    def state_dtype(self, field: str):
        """The numpy dtype of one BpcgState field under this solver's
        precision policy (restore casts through it)."""
        if field in ("iters", "stall"):
            return np.int32
        if field in ("active", "stalled"):
            return np.bool_
        return np.dtype(_NUMPY_DTYPE[self.dtype])

    def state_to_host(self, state: BpcgState) -> dict[str, np.ndarray]:
        """One host numpy array per BpcgState field, bitwise (a sharded
        field gathered)."""
        return {
            f.name: _numpy(getattr(state, f.name))
            for f in dataclasses.fields(BpcgState)
        }

    def _check_batch(self, sizes: dict[str, float], what: str) -> None:
        """Every array holds the same number of scenario rows (``sizes``:
        name -> leading size over the rows a scenario takes there)."""
        if len(set(sizes.values())) != 1:
            raise ValueError(f"{what}: the arrays do not share one batch size: {sizes}")

    def state_from_host(
        self, arrays: dict[str, np.ndarray], *, place: bool = True
    ) -> BpcgState:
        """Rebuild a :class:`BpcgState` from a :meth:`state_to_host`
        snapshot, each field cast to :meth:`state_dtype`.  ``place=True``
        checks that every field has one batch size, which must divide the
        mesh, and puts the state on this solver's device or mesh (the
        snapshot may come from another device count); ``place=False``
        leaves CPU tensors (for a ``take_rows`` right after, when the old
        batch does not divide the new mesh)."""
        state = BpcgState(**{
            f.name: torch.from_numpy(
                np.asarray(arrays[f.name], dtype=self.state_dtype(f.name))
            )
            for f in dataclasses.fields(BpcgState)
        })
        if not place:
            return state
        self._check_batch(
            {f.name: getattr(state, f.name).shape[0] for f in dataclasses.fields(BpcgState)},
            "state_from_host",
        )
        self._check_mesh(state.x.shape[0], "state_from_host")
        return self._put(state)

    def _prep_dtype(self, name: str) -> torch.dtype:
        """The dtype of the prep leaf ``name`` under this solver's policy."""
        if name == "chol":
            return self.coarse_dtype
        return self.dtype if name.endswith("_solve") else self.precond_dtype

    def prep_to_host(self, prep: dict) -> dict[str, np.ndarray]:
        """One host numpy array per prep tensor, bitwise (see the
        contract note above for the names); a bfloat16 leaf as its uint16
        bit patterns."""
        get = _numpy
        out: dict[str, np.ndarray] = {}
        for i, (lw, mw) in enumerate(zip(prep["lam_w"], prep["mu_w"])):
            out[f"lam_w{i}"] = get(lw)
            out[f"mu_w{i}"] = get(mw)
        for i, (d, m) in enumerate(zip(prep["dinv"], prep["lmax"])):
            out[f"dinv{i}"] = get(d)
            out[f"lmax{i}"] = get(m)
        out["chol"] = get(prep["chol"])
        if self._split_fine:
            out["lam_w_solve"] = get(prep["lam_w_solve"])
            out["mu_w_solve"] = get(prep["mu_w_solve"])
        return out

    def prep_from_host(
        self, arrays: dict[str, np.ndarray], *, place: bool = True
    ) -> dict:
        """Rebuild a prep dict from a :meth:`prep_to_host` snapshot
        (``place`` as in :meth:`state_from_host`).  Raises KeyError when
        the snapshot's levels do not match this solver's, e.g. a
        checkpoint of another discretization, or a mixed policy's twins
        missing for this one."""
        n_lv = len(self.spaces)
        names = [f"{n}{i}" for i in range(n_lv) for n in ("lam_w", "mu_w")]
        names += [f"{n}{i}" for i in range(n_lv - 1) for n in ("dinv", "lmax")]
        names += ["chol"]
        if self._split_fine:
            names += ["lam_w_solve", "mu_w_solve"]
        t = {name: _from_numpy(arrays[name], self._prep_dtype(name)) for name in names}
        if place:
            # The weighted fields fold each scenario's elements into axis 0.
            per = {f"{n}{i}": sp.nelem for i, sp in enumerate(self.spaces)
                   for n in ("lam_w", "mu_w")}
            per["lam_w_solve"] = per["mu_w_solve"] = self.fine_space.nelem
            self._check_batch(
                {name: a.shape[0] / per.get(name, 1) for name, a in t.items()},
                "prep_from_host",
            )
            self._check_mesh(t["chol"].shape[0], "prep_from_host")
            t = self._put(t)
        prep = {
            "lam_w": tuple(t[f"lam_w{i}"] for i in range(n_lv)),
            "mu_w": tuple(t[f"mu_w{i}"] for i in range(n_lv)),
            "dinv": tuple(t[f"dinv{i}"] for i in range(n_lv - 1)),
            "lmax": tuple(t[f"lmax{i}"] for i in range(n_lv - 1)),
            "chol": t["chol"],
        }
        if self._split_fine:
            prep["lam_w_solve"] = t["lam_w_solve"]
            prep["mu_w_solve"] = t["mu_w_solve"]
        return prep

    def _restrict_field(self, field: torch.Tensor, level: int) -> torch.Tensor:
        """Restrict a (S, nelem_fine) per-element coefficient field to
        hierarchy level ``level`` by averaging each level element's fine
        descendants (:func:`~repro_torch.solvers.gmg.restrict_field`, an
        exact pairwise halving tree).  Identity on levels that share the
        fine mesh."""
        desc = self._desc_idx[level]
        return field if desc is None else restrict_field(field, desc)

    def _prepare_body(self, lam_vals, mu_vals, reset_mask, prep) -> tuple[dict, torch.Tensor]:
        """Fold the (S, nelem_fine) material fields of the masked rows into
        the per-level weighted fields (coarser levels through
        :meth:`_restrict_field`) and recompute the derived per-scenario data
        (smoother dinv/lambda_max, coarse Cholesky) for exactly those rows;
        unmasked rows keep their prep bitwise.  Returns ``(prep, bad)``:
        ``bad`` is a device bool, True when a reset row's coarse matrix is
        not positive definite (the caller reads it)."""
        s = lam_vals.shape[0]
        mask3 = reset_mask[:, None, None]
        lam_w, mu_w, dinv, lmax = [], [], [], []
        chol = None
        for i, base in enumerate(self._base_ops):
            prev = base.with_material_weights(prep["lam_w"][i], prep["mu_w"][i], s)
            op = prev.with_materials_rows(
                self._restrict_field(lam_vals, i),
                self._restrict_field(mu_vals, i),
                reset_mask,
            )
            lam_w.append(op.lam_w)
            mu_w.append(op.mu_w)
            if i == 0:
                # Probe and factor at the coarse dtype, through the coarse
                # carrier on this level's weighted fields upcast.  Rows
                # outside the mask may hold no materials yet (an empty
                # prep): their factor is discarded.
                cdt = self.coarse_dtype
                K = probe_coarse_matrix(self._coarse_base.with_material_weights(
                    op.lam_w.to(cdt), op.mu_w.to(cdt), s))
                L, info = torch.linalg.cholesky_ex(K)
                bad = ((info != 0) & reset_mask).any()
                chol = torch.where(mask3, L, prep["chol"])
            else:
                cop = op.constrained()
                sm = ChebyshevSmoother.setup(
                    cop,
                    cop.diagonal(),
                    degree=self.cheb_degree,
                    power_iters=self.power_iters,
                    v0=self._start_vectors[i - 1],
                    batch_dims=1,
                )
                dinv.append(torch.where(mask3, sm.dinv, prep["dinv"][i - 1]))
                lmax.append(torch.where(reset_mask, sm.lmax, prep["lmax"][i - 1]))
        out = {
            "lam_w": tuple(lam_w),
            "mu_w": tuple(mu_w),
            "dinv": tuple(dinv),
            "lmax": tuple(lmax),
            "chol": chol,
        }
        if self._split_fine:
            # Solve-dtype twin of the fine-level weighted fields: the outer
            # Krylov's operator apply runs at full precision while the
            # smoother streams the reduced copy.
            prev = self._fine_base_solve.with_material_weights(
                prep["lam_w_solve"], prep["mu_w_solve"], s
            )
            op = prev.with_materials_rows(lam_vals, mu_vals, reset_mask)
            out["lam_w_solve"] = op.lam_w
            out["mu_w_solve"] = op.mu_w
        return out, bad

    def _build_from_prep(self, prep):
        """Hierarchy and preconditioner from a prep dict: binds the stored
        weighted fields and smoother data — no power iterations, no
        probing, no factorization.

        Returns ``(levels, gmg, A, M)``: ``A`` is the outer Krylov operator
        at ``solve_dtype`` and ``M`` the preconditioner with the
        solve <-> precond casts folded in."""
        s = prep["chol"].shape[0]
        levels = []
        for i, base in enumerate(self._base_ops):
            op = base.with_material_weights(prep["lam_w"][i], prep["mu_w"][i], s)
            cop = op.constrained()
            smoother = None
            if i > 0:
                smoother = ChebyshevSmoother(
                    A=cop,
                    dinv=prep["dinv"][i - 1],
                    lmax=prep["lmax"][i - 1],
                    degree=self.cheb_degree,
                )
            levels.append(
                Level(
                    space=self.spaces[i],
                    operator=op,
                    constrained=cop,
                    smoother=smoother,
                    ess_mask=op.ess_mask,
                )
            )
        coarse = cholesky_solver(prep["chol"])
        if self.coarse_dtype != self.precond_dtype:
            inner, cdt, pdt = coarse, self.coarse_dtype, self.precond_dtype
            coarse = lambda r: inner(r.to(cdt)).to(pdt)  # noqa: E731
        gmg = GMGPreconditioner(
            levels=levels, transfers=self.transfers, coarse_solve=coarse
        )
        if self._split_fine:
            fine_solve = self._fine_base_solve.with_material_weights(
                prep["lam_w_solve"], prep["mu_w_solve"], s
            )
            A = fine_solve.constrained()
            sdt, pdt = self.dtype, self.precond_dtype
            M = lambda r: gmg(r.to(pdt)).to(sdt)  # noqa: E731
        else:
            A = levels[-1].constrained
            M = gmg
        return levels, gmg, A, M

    def _rhs(self, tractions: torch.Tensor) -> torch.Tensor:
        b = self._traction_pattern[None, :, None] * tractions[:, None, :]
        return torch.where(self._fine_ess, 0.0, b)  # homogeneous elimination

    def _row_tensor(self, values, s: int) -> torch.Tensor:
        return torch.as_tensor(values, dtype=self.dtype, device=self.device).expand(s)

    # -- public entry ------------------------------------------------------------
    def pack_materials(self, materials: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalize a length-S scenario list into (S, nelem_fine)
        per-element coefficient fields, in the solve dtype on the device.

        Each entry is either an attribute -> (lambda, mu) dict
        (piecewise-constant by mesh attribute) or a ``(lam_e, mu_e)`` array
        pair of shape (nelem_fine,) giving one coefficient per FINE-mesh
        element; the two forms mix freely within one batch.  Raises
        ValueError naming the scenario and the missing/offending attribute
        (dicts) or the mismatched shape / first non-positive element index
        (arrays)."""
        ne = self.fine_space.nelem
        fine_mesh = self.fine_space.mesh
        lam = np.empty((len(materials), ne))
        mu = np.empty_like(lam)
        for si, m in enumerate(materials):
            where = f"scenario {si} materials"
            if isinstance(m, dict):
                check_material_dict(m, self.attr_values, where=where)
                lam[si], mu[si] = material_fields(fine_mesh, m)
                continue
            if getattr(m, "ndim", None) is not None and np.ndim(m) != 1:
                # A bare 2-D array entry means the caller passed the raw
                # stacked (lam_2d, mu_2d) pair itself instead of a scenario
                # list; unpacking its rows would cross-pair lambda and mu.
                raise TypeError(
                    f"{where}: got a {np.ndim(m)}-D array as a scenario entry; "
                    f"pack_materials takes a LIST of per-scenario entries "
                    f"(dicts or (lam_e, mu_e) pairs); for a pre-stacked "
                    f"(S, nelem) pair use list(zip(lam, mu))"
                )
            try:
                lam_e, mu_e = m
            except (TypeError, ValueError):
                raise TypeError(
                    f"{where}: expected an attribute->(lambda, mu) dict or a "
                    f"(lam_e, mu_e) array pair, got {type(m).__name__!r}"
                ) from None
            lam[si], mu[si] = check_material_fields(lam_e, mu_e, ne, where=where)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)  # noqa: E731
        return as_t(lam), as_t(mu)

    def prepare(self, lam_vals, mu_vals, reset_mask, prep: dict) -> dict:
        """Fold the masked rows' new materials into the per-row operator
        fields and refresh their derived data (see :meth:`_prepare_body`).

        ``lam_vals``/``mu_vals`` are (S, nelem_fine) per-element fields (the
        output of :meth:`pack_materials`).  Rows NOT selected by
        ``reset_mask`` keep their prep bitwise.  Sharded, every shard
        prepares its rows on its device, and the positive-definiteness
        flags are read on the host once."""
        s, ne = lam_vals.shape
        if ne != self.fine_space.nelem:
            raise ValueError(
                f"prepare: material fields have {ne} elements per row, "
                f"expected nelem_fine = {self.fine_space.nelem}"
            )
        self._check_mesh(s, "prepare")
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)  # noqa: E731
        args = (
            as_t(lam_vals, self.dtype), as_t(mu_vals, self.dtype),
            as_t(reset_mask, torch.bool), prep,
        )
        outs, bad = [], []
        for prog, shard in zip(self._programs, self._shards(args)):
            out, b = prog._prepare_body(*shard)
            outs.append(out)
            bad.append(b)
        if _host_any(bad):
            raise ValueError(
                "prepare: a reset row's coarse matrix is not positive definite"
            )
        return self._join(outs)

    def run_chunk(
        self, tractions, rel_tol, reset_mask, state: BpcgState, prep: dict,
        k_iters: int, *, do_reset: bool = False,
    ) -> tuple[BpcgState, torch.Tensor]:
        """Advance the batch by up to ``k_iters`` iterations.  With
        ``do_reset`` the masked rows are first re-initialized for their
        (new) tractions/tolerances: x = 0, r = b, fresh thresholds,
        iteration count 0 (their materials must already be folded into
        ``prep`` through :meth:`prepare`); rows outside the mask resume
        bit-identically.

        Returns ``(state, consumed)`` where ``consumed`` is the (S,) int32
        count of iterations each row executed inside this chunk (0 for rows
        that entered inactive).  Sharded, the batch size must divide the
        mesh, the shards advance in lockstep (:func:`bpcg_chunk_shards`)
        and both results are split over the mesh."""
        tractions = torch.as_tensor(tractions, dtype=self.dtype, device=self.device)
        s = tractions.shape[0]
        self._check_mesh(s, "run_chunk")
        rel = mask = None
        if do_reset:
            rel = self._row_tensor(rel_tol, s)
            mask = torch.as_tensor(reset_mask, dtype=torch.bool, device=self.device)
        ops, states, rhs, starts = [], [], [], []
        for prog, (tr, rel_k, mask_k, st, pr) in zip(
            self._programs, self._shards((tractions, rel, mask, state, prep))
        ):
            _, _, A, M = prog._build_from_prep(pr)
            b = prog._rhs(tr)
            if do_reset:
                st = merge_states(
                    mask_k, bpcg_init(A, b, M=M, rel_tol=rel_k, flexible=self.flexible), st
                )
            ops.append((A, M))
            states.append(st)
            rhs.append(b)
            starts.append(st.iters)
        outs = bpcg_chunk_shards(
            ops, states, k_iters=int(k_iters), maxiter=self.maxiter,
            stall_iters=self.stall_iters, stall_rtol=self.stall_rtol,
            flexible=self.flexible,
        )
        if self.stall_iters > 0:
            outs = [
                true_residual_audit(A, M, b, out)
                for (A, M), b, out in zip(ops, rhs, outs)
            ]
        consumed = [out.iters - s0 for out, s0 in zip(outs, starts)]
        return self._join(outs), self._join(consumed)

    def _f64_fallback_solver(self) -> "BatchedGMGSolver":
        """The lazily built f64 twin that re-solves stalled rows: same
        discretization, device and start vectors, the ``f64`` policy (which
        never recurses: its own detector is disarmed)."""
        if self._f64_twin is None:
            self._f64_twin = BatchedGMGSolver(
                self.coarse_mesh,
                self.n_h_refine,
                self.p_target,
                assembly=self.assembly,
                precision="f64",
                device=self.device,
                start_vectors=self._start_vectors_arg,
                cheb_degree=self.cheb_degree,
                power_iters=self.power_iters,
                ess_faces=self._ess_faces,
                traction_face=self._traction_face,
                maxiter=self.maxiter,
                mesh=self.mesh,
            )
        return self._f64_twin

    def solve(self, materials: list, tractions, rel_tol) -> BPCGResult:
        """Solve S scenarios at once.

        materials: length-S list; each entry an attribute->(lambda, mu)
                   dict or a (lam_e, mu_e) per-element array pair of shape
                   (nelem_fine,) — the forms mix freely (see
                   :meth:`pack_materials`)
        tractions: (S, 3) traction vectors on the traction face
        rel_tol:   scalar or (S,) per-scenario relative tolerances

        Reduced-precision policies carry the f64 safety net: rows the
        stagnation detector or the true-residual audit flagged are
        re-solved on the lazily built f64 twin and merged back —
        ``fallback`` marks them, ``iterations`` counts the total work
        (reduced + f64 passes), and the merged result is promoted to f64.

        A sharded solver pads S to a multiple of the device count with
        born-converged rows (:meth:`pad_scenarios`) and slices them off:
        the result holds the S rows asked for, gathered onto
        ``self.device``."""
        materials, tractions, rel_tol, s = self.pad_scenarios(
            materials, tractions, rel_tol
        )
        n = len(materials)
        lam_vals, mu_vals = self.pack_materials(materials)
        ones = torch.ones((n,), dtype=torch.bool, device=self.device)
        prep = self.prepare(lam_vals, mu_vals, ones, self.empty_prep(n))
        state, _ = self.run_chunk(
            tractions, rel_tol, ones, self.empty_state(n), prep, self.maxiter,
            do_reset=True,
        )
        res = bpcg_result(state)
        if n > s:
            res = BPCGResult(**{
                f.name: getattr(res, f.name)[:s] for f in dataclasses.fields(BPCGResult)
            })
        if self.precision.reduced:
            need = (res.stalled & ~res.converged).cpu().numpy()
            if need.any():
                rows = np.nonzero(need)[0]
                sub = self._f64_fallback_solver().solve(
                    [materials[int(i)] for i in rows],
                    np.asarray(tractions, dtype=np.float64)[rows],
                    np.asarray(rel_tol, dtype=np.float64)[rows],
                )
                res = _merge_fallback_rows(res, sub, rows)
        return res
