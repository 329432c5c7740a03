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
from repro_torch.core.operators import DEFER_MATERIALS, ElasticityOperator
from repro_torch.core.precision import PrecisionPolicy, resolve_precision
from repro_torch.device import resolve_device
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
    "bpcg_result",
    "true_residual_audit",
    "merge_states",
    "BpcgState",
    "BPCGResult",
    "BatchedGMGSolver",
]

_NUMPY_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


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


def bpcg_init(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    *,
    x0=None,
    rel_tol=1e-6,
    abs_tol=0.0,
) -> BpcgState:
    """Build the initial :class:`BpcgState` for ``A x = b``.

    MFEM-style thresholds, per scenario: a row stops when
    ``nom <= max(nom0 * rel_tol^2, abs_tol^2)``; ``rel_tol``/``abs_tol``
    may be scalars or (S,) arrays.  A row with a zero RHS is born
    converged (0 iterations), which is also what makes padding rows free."""
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
    rel = torch.as_tensor(rel_tol, dtype=nom0.dtype, device=nom0.device).expand(s)
    ab = torch.as_tensor(abs_tol, dtype=nom0.dtype, device=nom0.device).expand(s)
    threshold = torch.maximum(nom0 * rel**2, ab**2)
    zeros = torch.zeros((s,), dtype=torch.int32, device=b.device)
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
        stalled=torch.zeros((s,), dtype=torch.bool, device=b.device),
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
) -> BpcgState:
    """Advance every active row by up to ``k_iters`` PCG iterations
    (to convergence or ``maxiter`` when ``k_iters`` is None).

    Chunked resumption is exact: inactive rows are frozen (alpha forced
    to 0, direction updates gated), so ``chunk(k1)`` followed by
    ``chunk(k2)`` yields the same state as one ``chunk(k1 + k2)`` call.

    Stagnation detection (the reduced-precision safety net): with
    ``stall_iters > 0``, a row that goes ``stall_iters`` consecutive
    iterations without reducing its best-seen ``nom`` by at least a
    factor ``stall_rtol`` is flagged ``stalled`` (sticky) and deactivated:
    it has hit the precision floor of the arithmetic.  The default
    ``stall_iters = 0`` leaves the detector out of the loop entirely, so
    the f64 path does no extra arithmetic."""
    M = M or _identity
    st, step = state, 0
    while (k_iters is None or step < k_iters) and bool(st.active.any()):
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
        beta = torch.where(ok, betanom / torch.where(st.nom == 0, 1.0, st.nom), 0.0)
        d = torch.where(
            _col(active, st.d.ndim), z + _col(beta, st.d.ndim) * st.d, st.d
        )
        nom = torch.where(active, betanom, st.nom)
        # Count only real steps (ok), matching scalar pcg: an aborted
        # degenerate direction (den <= 0) takes no step and adds none.
        iters = st.iters + ok.to(torch.int32)
        active = ok & (nom > st.threshold) & (iters < maxiter)
        new = dataclasses.replace(
            st, x=x, r=r, z=z, d=d, nom=nom, iters=iters, active=active
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
                stalled=st.stalled | hit,
            )
        st, step = new, step + 1
    return st


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
    lying = claimed & (nomt > state.threshold * slack)
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
    return BPCGResult(
        x=state.x,
        iterations=state.iters,
        converged=state.nom <= state.threshold,
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
) -> BPCGResult:
    """MFEM-style PCG over a leading scenario axis with masked convergence.

    ``A`` and ``M`` map (S, ...) batches to (S, ...) batches with no
    cross-scenario coupling; ``rel_tol``/``abs_tol`` may be scalars or
    (S,) tensors.  The resumable step program run in one uninterrupted
    chunk (see :func:`bpcg_init` / :func:`bpcg_chunk`)."""
    state = bpcg_init(A, b, M, x0=x0, rel_tol=rel_tol, abs_tol=abs_tol)
    state = bpcg_chunk(
        A, state, M, k_iters=None, maxiter=maxiter,
        stall_iters=stall_iters, stall_rtol=stall_rtol,
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

    Precision: ``precision`` names a
    :class:`~repro_torch.core.precision.PrecisionPolicy` (``"f64"``,
    ``"f32"``, ``"mixed"`` or a policy object).  The outer Krylov loop
    runs in ``policy.solve_dtype`` (``self.dtype``), the V-cycle in
    ``policy.precond_dtype``, the coarse probe/Cholesky in
    ``policy.coarse_dtype``.  When the solve and V-cycle dtypes differ the
    fine level keeps a second, solve-dtype copy of its weighted fields
    (``prep["lam_w_solve"]``/``prep["mu_w_solve"]``).  Reduced policies
    run with the stagnation detector on, and ``solve`` re-solves any
    stalled rows on a lazily built f64 twin (``fallback`` marks them).

    ``start_vectors`` holds the power iteration's start vector of every
    smoothed level (coarse -> fine), each of the per-scenario shape
    (nscalar, 3) and broadcast over the batch; without it each level
    draws one from a generator seeded with 1234, as
    :func:`~repro_torch.solvers.gmg.build_hierarchy` does.
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
    ):
        self.coarse_mesh = coarse_mesh
        self.n_h_refine = n_h_refine
        self.p_target = p_target
        self.assembly = assembly
        self.device = resolve_device(device)
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
        self._base_ops = [self._carrier(sp, self.precond_dtype) for sp in spaces]
        self._desc_idx = level_descendants(spaces, self.device)
        self._fine_base_solve = (
            self._carrier(spaces[-1], self.dtype) if self._split_fine else None
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

    def _carrier(self, space: H1Space, dtype) -> ElasticityOperator:
        """A geometry/tables carrier: every call binds per-scenario fields."""
        return ElasticityOperator(
            space, assembly=self.assembly, materials=DEFER_MATERIALS, dtype=dtype,
            device=self.device, ess_faces=self._ess_faces,
        )

    @property
    def fine_space(self) -> H1Space:
        return self.spaces[-1]

    def pad_batch(self, n: int) -> int:
        """Rows a batch of ``n`` scenarios is padded to by default: ``n``
        (the scenario axis is not sharded across cards)."""
        return n

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

    def empty_prep(self, s: int) -> dict:
        """Zero-filled prep of the right shapes for an S-row batch.  Only
        meaningful as the ``prep`` argument of a ``prepare`` call whose
        reset mask covers every row that will ever be read."""
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
        (every row must be reset before its first chunk)."""
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
        may be shorter or longer than the old batch."""
        idx = self._rows(rows)
        new_state = BpcgState(**{
            f.name: getattr(state, f.name).index_select(0, idx)
            for f in dataclasses.fields(BpcgState)
        })
        return new_state, self._prep_map(prep, lambda a: a.index_select(0, idx))

    def copy_prep_rows(self, prep: dict, src, dst) -> dict:
        """Duplicate prepared batch rows: row ``dst[i]`` takes row
        ``src[i]``'s derived data (weighted fields, smoother dinv/lmax,
        coarse factor) bitwise.  Every source is gathered before any
        destination is written, so a row may donate its prep while it is
        overwritten itself.  Prep depends only on a row's materials, so a
        refilled slot whose materials match a prepared row skips
        ``prepare``.  The input prep is left unchanged."""
        s_idx, d_idx = self._rows(src), self._rows(dst)
        return self._prep_map(
            prep, lambda a: a.index_copy(0, d_idx, a.index_select(0, s_idx))
        )

    def _restrict_field(self, field: torch.Tensor, level: int) -> torch.Tensor:
        """Restrict a (S, nelem_fine) per-element coefficient field to
        hierarchy level ``level`` by averaging each level element's fine
        descendants (:func:`~repro_torch.solvers.gmg.restrict_field`, an
        exact pairwise halving tree).  Identity on levels that share the
        fine mesh."""
        desc = self._desc_idx[level]
        return field if desc is None else restrict_field(field, desc)

    def _prepare_body(self, lam_vals, mu_vals, reset_mask, prep) -> dict:
        """Fold the (S, nelem_fine) material fields of the masked rows into
        the per-level weighted fields (coarser levels through
        :meth:`_restrict_field`) and recompute the derived per-scenario data
        (smoother dinv/lambda_max, coarse Cholesky) for exactly those rows;
        unmasked rows keep their prep bitwise."""
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
                # Probe at the V-cycle dtype (the operator's own), factor at
                # the coarse dtype.  Rows outside the mask may hold no
                # materials yet (an empty prep): their factor is discarded.
                K = probe_coarse_matrix(op).to(self.coarse_dtype)
                L, info = torch.linalg.cholesky_ex(K)
                if bool(((info != 0) & reset_mask).any()):
                    raise ValueError(
                        "prepare: a reset row's coarse matrix is not positive definite"
                    )
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
        return out

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
        ``reset_mask`` keep their prep bitwise."""
        s, ne = lam_vals.shape
        if ne != self.fine_space.nelem:
            raise ValueError(
                f"prepare: material fields have {ne} elements per row, "
                f"expected nelem_fine = {self.fine_space.nelem}"
            )
        mask = torch.as_tensor(reset_mask, dtype=torch.bool, device=self.device)
        return self._prepare_body(
            torch.as_tensor(lam_vals, dtype=self.dtype, device=self.device),
            torch.as_tensor(mu_vals, dtype=self.dtype, device=self.device),
            mask,
            prep,
        )

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
        that entered inactive)."""
        tractions = torch.as_tensor(tractions, dtype=self.dtype, device=self.device)
        s = tractions.shape[0]
        _, _, A, M = self._build_from_prep(prep)
        b = self._rhs(tractions)
        if do_reset:
            fresh = bpcg_init(A, b, M=M, rel_tol=self._row_tensor(rel_tol, s))
            state = merge_states(reset_mask, fresh, state)
        start_iters = state.iters
        out = bpcg_chunk(
            A, state, M=M, k_iters=int(k_iters), maxiter=self.maxiter,
            stall_iters=self.stall_iters, stall_rtol=self.stall_rtol,
        )
        if self.stall_iters > 0:
            out = true_residual_audit(A, M, b, out)
        return out, out.iters - start_iters

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
        (reduced + f64 passes), and the merged result is promoted to f64."""
        materials, tractions, rel_tol, s = self.pad_scenarios(
            materials, tractions, rel_tol
        )
        lam_vals, mu_vals = self.pack_materials(materials)
        ones = torch.ones((s,), dtype=torch.bool, device=self.device)
        prep = self.prepare(lam_vals, mu_vals, ones, self.empty_prep(s))
        state, _ = self.run_chunk(
            tractions, rel_tol, ones, self.empty_state(s), prep, self.maxiter,
            do_reset=True,
        )
        res = bpcg_result(state)
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
