"""The port's batched multi-scenario solver vs the reference, on the CPU.

Every module the batched slice touches is held against its namesake in
``src/repro/`` on the same numpy inputs: the fine-descendant maps, the
scenario-folded operator, the batched smoother and coarse matrix, ``bpcg``
and ``BatchedGMGSolver.solve`` in f64, mixed and f32.  The power
iterations' start vectors are the reference's
(``jax.random.normal(PRNGKey(1234), (nscalar, 3), dtype)`` per smoothed
level), so lambda_max and then the iteration counts match.  Bitwise
properties (chunked resumption, masked refill, dict == piecewise-constant
field) are checked within the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operators import ElasticityOperator as RefOperator
from repro.fem import mesh as ref_mesh
from repro.fem.space import H1Space as RefSpace
from repro.fem.transfer import make_transfer as ref_make_transfer
from repro.solvers.batched import BatchedGMGSolver as RefSolver
from repro.solvers.batched import bpcg as ref_bpcg
from repro.solvers.chebyshev import ChebyshevSmoother as RefSmoother
from repro.solvers.coarse import probe_coarse_matrix as ref_probe
from repro_torch import convert
from repro_torch.core.geometry import material_fields
from repro_torch.core.operators import ElasticityOperator
from repro_torch.fem.mesh import beam_hex, fine_descendants
from repro_torch.fem.space import H1Space
from repro_torch.fem.transfer import make_transfer
from repro_torch.kernels.pa_elasticity import ops
from repro_torch.launch.solve import solve_beam
from repro_torch.solvers import BatchedGMGSolver, bpcg
from repro_torch.solvers.cg import pcg
from repro_torch.solvers.chebyshev import ChebyshevSmoother
from repro_torch.solvers.coarse import make_coarse_solver, probe_coarse_matrix
from repro_torch.solvers.gmg import build_hierarchy, hierarchy_spaces, level_descendants

MATS = {1: (50.0, 50.0), 2: (1.0, 1.0)}
MATS_B = {1: (10.0, 5.0), 2: (2.0, 2.0)}
MATS_C = {1: (10.0, 8.0), 2: (2.0, 1.5)}
TR = (0.0, 0.0, -1e-2)
# x against the reference, relative and of max |x|: f64 to 1e-10; an f32
# V-cycle perturbs every iterate at f32 rounding (eps 1.2e-7), so mixed
# agrees to 1e-6 and f32 to 1e-4.
X_RTOL = {"f64": 1e-10, "mixed": 1e-6, "f32": 1e-4}
_NE1 = beam_hex().refined().nelem  # elements of the once-refined beam


def _field(nelem, seed):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(0.0, 0.5, nelem), rng.lognormal(0.0, 0.5, nelem))


def _ref_start_vectors(refine, p, dtype=np.float64):
    key = jax.random.PRNGKey(1234)
    return [
        np.array(jax.random.normal(key, (sp.nscalar, 3), dtype=dtype))
        for sp in hierarchy_spaces(beam_hex(), refine, p)[1:]
    ]


def _solver(refine, p, precision="f64", **kw):
    """The port's solver on the CPU with the reference's start vectors."""
    dt = np.float64 if precision == "f64" else np.float32
    return BatchedGMGSolver(
        beam_hex(), refine, p, precision=precision, device="cpu",
        start_vectors=_ref_start_vectors(refine, p, dt), **kw,
    )


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max()
    )


def _mixed_batch(nelem):
    """dict, per-element field, dict: the two forms in one batch."""
    return [MATS, _field(nelem, 1), MATS_B]


# -- setup layer and modules ---------------------------------------------------


@pytest.mark.parametrize("coarse, fine", [(0, 0), (0, 1), (0, 2), (1, 3)])
def test_fine_descendants_match_reference(coarse, fine):
    rb = ref_mesh.beam_hex()
    got = fine_descendants(beam_hex().refined(coarse), beam_hex().refined(fine))
    want = ref_mesh.fine_descendants(rb.refined(coarse), rb.refined(fine))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("refine, p", [(0, 2), (2, 2)])
def test_level_descendants_match_reference(refine, p):
    """One map per level onto the finest mesh (None on the fine mesh's
    p-levels), as the reference's solver restricts its fields."""
    rb = ref_mesh.beam_hex()
    spaces = hierarchy_spaces(beam_hex(), refine, p)
    descs = level_descendants(spaces, "cpu")
    assert len(descs) == len(spaces)
    for sp, d in zip(spaces, descs):
        if sp.nelem == spaces[-1].nelem:
            assert d is None
            continue
        k = round(np.log2(sp.mesh.nx / beam_hex().nx))
        want = ref_mesh.fine_descendants(rb.refined(k), rb.refined(refine))
        assert d.dtype == torch.int64
        np.testing.assert_array_equal(d.numpy(), want)


def test_fine_descendants_rejects_non_refinement():
    with pytest.raises(ValueError, match="power-of-two refinement"):
        fine_descendants(beam_hex(), beam_hex(nx=12, ny=3, nz=3))


@pytest.mark.parametrize("assembly", ["paop", "paop_cuda"])
@pytest.mark.parametrize("p", [1, 2])
def test_batched_operator_matches_reference_per_row(p, assembly):
    rm = ref_mesh.beam_hex().refined()
    mats = _mixed_batch(rm.nelem)
    ref = RefOperator(RefSpace(rm, p), assembly="paop", materials=mats)
    op = ElasticityOperator(
        H1Space(convert.hex_mesh(rm), p), assembly=assembly, materials=mats,
        device="cpu",
    )
    assert op.nbatch == ref.nbatch == 3
    x = np.random.default_rng(p).standard_normal((3, ref.space.nscalar, 3))
    rcop = ref.constrained()
    refs = jax.jit(lambda v: (ref.apply(v), ref.diagonal(), rcop(v), rcop.diagonal()))(
        jnp.asarray(x)
    )
    before = ops.counts["pa_elasticity"].plain_calls
    cop = op.constrained()
    xt = torch.from_numpy(x)
    for got, want in zip((op.apply(xt), op.diagonal(), cop(xt), cop.diagonal()), refs):
        assert got.shape == (3, ref.space.nscalar, 3)
        _close(got, want, 1e-12)
    # one plain call per apply: the three scenarios go through as one grid
    calls = ops.counts["pa_elasticity"].plain_calls - before
    assert calls == (2 if assembly == "paop_cuda" else 0)


def test_operator_with_methods_are_shallow_and_rowwise():
    sp = H1Space(beam_hex(), 1)
    base = ElasticityOperator(sp, materials="defer", device="cpu")
    assert base.lam_w is None and base.nbatch is None
    with pytest.raises(ValueError, match="deferred"):
        base.apply(torch.zeros((sp.nscalar, 3), dtype=torch.float64))
    lam = torch.tensor(np.stack([np.full(8, 2.0), np.full(8, 3.0)]))
    op = base.with_materials(lam, 2 * lam)
    assert op.nbatch == 2 and op.w_detj is base.w_detj and op.B is base.B
    new = op.with_materials_rows(5 * lam, 6 * lam, torch.tensor([False, True]))
    assert torch.equal(new.lam_w[:8], op.lam_w[:8])  # row 0 kept bitwise
    assert torch.equal(new.lam_w[8:], (15.0 * base.w_detj).expand(8, -1, -1, -1))
    same = base.with_material_weights(op.lam_w, op.mu_w, 2)
    x = torch.randn((2, sp.nscalar, 3), dtype=torch.float64)
    assert torch.equal(same.apply(x), op.apply(x))
    with pytest.raises(ValueError, match="scenario-batched"):
        ElasticityOperator(sp, device="cpu").with_materials_rows(lam, lam, [True, True])


def test_mask_and_transfer_broadcast_over_scenarios():
    rc, rf = ref_mesh.beam_hex(), ref_mesh.beam_hex().refined()
    c, f = H1Space(convert.hex_mesh(rc), 1), H1Space(convert.hex_mesh(rf), 1)
    t = make_transfer(c, f, dtype=torch.float64, device="cpu")
    rt = ref_make_transfer(RefSpace(rc, 1), RefSpace(rf, 1), dtype=jnp.float64)
    rng = np.random.default_rng(4)
    uc = rng.standard_normal((2, c.nscalar, 3))
    rf_ = rng.standard_normal((2, f.nscalar, 3))
    _close(t.prolong(torch.from_numpy(uc)), rt.prolong(jnp.asarray(uc)), 1e-14)
    _close(t.restrict(torch.from_numpy(rf_)), rt.restrict(jnp.asarray(rf_)), 1e-14)
    # the (nscalar, 3) essential mask broadcasts against (S, nscalar, 3)
    ops_ = [ElasticityOperator(f, materials=m, device="cpu") for m in (MATS, MATS_B)]
    batch = ElasticityOperator(f, materials=[MATS, MATS_B], device="cpu")
    x = torch.from_numpy(rf_)
    y, d = batch.constrained()(x), batch.constrained().diagonal()
    for i, single in enumerate(ops_):
        _close(y[i], single.constrained()(x[i]).numpy(), 1e-13)
        _close(d[i], single.constrained().diagonal().numpy(), 1e-13)
    assert bool((d[:, batch.ess_mask] == 1.0).all())


def test_batched_smoother_matches_reference():
    rm = ref_mesh.beam_hex().refined()
    mats = _mixed_batch(rm.nelem)
    ref = RefOperator(RefSpace(rm, 2), assembly="paop", materials=mats)
    op = ElasticityOperator(H1Space(convert.hex_mesh(rm), 2), materials=mats, device="cpu")
    n = ref.space.nscalar
    rcop, cop = ref.constrained(), op.constrained()
    rsm = RefSmoother.setup(
        rcop, rcop.diagonal(), shape=(3, n, 3), dtype=jnp.float64, batch_dims=1
    )
    v0 = _ref_start_vectors(1, 2)[-1]
    sm = ChebyshevSmoother.setup(
        cop, cop.diagonal(), v0=torch.from_numpy(v0), batch_dims=1
    )
    assert sm.lmax.shape == (3,)
    _close(sm.lmax, rsm.lmax, 1e-10)
    b = np.random.default_rng(5).standard_normal((3, n, 3))
    _close(sm(torch.from_numpy(b)), rsm(jnp.asarray(b)), 1e-10)
    with pytest.raises(ValueError, match="start vector shape"):
        ChebyshevSmoother.setup(
            cop, cop.diagonal(), v0=torch.zeros((3, n, 3), dtype=torch.float64),
            batch_dims=1,
        )


@pytest.mark.parametrize("batched", [False, True])
def test_coarse_matrix_matches_reference(batched):
    rm = ref_mesh.beam_hex()
    mats = _mixed_batch(rm.nelem) if batched else _field(rm.nelem, 3)
    ref = RefOperator(RefSpace(rm, 1), assembly="paop", materials=mats)
    op = ElasticityOperator(H1Space(convert.hex_mesh(rm), 1), materials=mats, device="cpu")
    n = ref.space.nscalar
    if batched:
        want = ref_probe(ref.constrained(), n, 3, jnp.float64)
    else:
        stacked = (np.stack([mats[0]] * 2), np.stack([mats[1]] * 2))
        batch1 = RefOperator(RefSpace(rm, 1), assembly="paop", materials=stacked)
        want = ref_probe(batch1.constrained(), n, 2, jnp.float64)[0]
    got = probe_coarse_matrix(op)
    assert got.shape == want.shape
    _close(got, want, 1e-12)
    # the batched Cholesky solve inverts every scenario's matrix
    b = torch.from_numpy(np.random.default_rng(6).standard_normal((3, n, 3)))
    b = torch.where(op.ess_mask, 0.0, b)
    if not batched:
        b = b[0]
    x = make_coarse_solver(op)(b)
    _close(op.constrained()(x), b.numpy(), 1e-9)


def test_folded_probe_equals_column_loop():
    """One apply of the n identity columns folded into the batch axis gives
    what n applies of one column each give, bitwise."""
    rm = ref_mesh.beam_hex()
    op = ElasticityOperator(
        H1Space(convert.hex_mesh(rm), 1), materials=_mixed_batch(rm.nelem), device="cpu"
    )
    n = op.space.nscalar * 3
    cop = op.constrained()
    eye = torch.eye(n, dtype=torch.float64)
    cols = [cop(eye[j].reshape(1, -1, 3).expand(3, -1, 3).contiguous()).reshape(3, n)
            for j in range(n)]
    assert torch.equal(probe_coarse_matrix(op), torch.stack(cols, dim=2))


def test_batched_hierarchy_solves_each_scenario():
    """build_hierarchy with a scenario sequence + bpcg gives each row what
    the single-scenario hierarchy + pcg of that row gives."""
    sv = _ref_start_vectors(1, 1)
    mats = [MATS, _field(_NE1, 3)]  # the field is restricted to the coarse level
    gmg = build_hierarchy(beam_hex(), 1, 1, materials=mats, device="cpu", start_vectors=sv)
    fine = gmg.fine
    b1 = torch.as_tensor(fine.space.traction_rhs("x1", TR))
    b = torch.where(fine.ess_mask, 0.0, torch.stack([b1, 2.0 * b1]))
    res = bpcg(fine.constrained, b, M=gmg, rel_tol=1e-10, maxiter=200)
    assert bool(res.converged.all())
    for i, m in enumerate(mats):
        g1 = build_hierarchy(beam_hex(), 1, 1, materials=m, device="cpu", start_vectors=sv)
        one = pcg(g1.fine.constrained, b[i], M=g1, rel_tol=1e-10, maxiter=200)
        assert int(res.iterations[i]) == one.iterations
        _close(res.x[i], one.x.numpy(), 1e-10)


@pytest.mark.parametrize("tols", [1e-10, [1e-2, 1e-6, 1e-12, 1e-4]])
def test_bpcg_matches_reference_on_spd_batch(tols):
    rng = np.random.default_rng(0)
    s, n = 4, 32
    m = rng.standard_normal((s, n, n))
    a = m @ m.transpose(0, 2, 1) + n * np.eye(n)
    b = rng.standard_normal((s, n))
    ref = ref_bpcg(
        lambda x: jnp.einsum("sij,sj->si", jnp.asarray(a), x), jnp.asarray(b),
        rel_tol=jnp.asarray(tols), maxiter=300,
    )
    at = torch.from_numpy(a)
    got = bpcg(
        lambda x: torch.einsum("sij,sj->si", at, x), torch.from_numpy(b),
        rel_tol=torch.as_tensor(tols), maxiter=300,
    )
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    _close(got.x, ref.x, 1e-10)


# -- BatchedGMGSolver against the reference ------------------------------------

# (precision, refine, p, materials, tractions, rel_tol): the configurations of
# tests/test_batched_solver.py (dict batches at p=1 and p=2) and
# tests/test_precision.py (mixed 1e-8 at refine 0), and a mixed dict/field
# batch with mixed tolerances in f64, mixed and f32 (where 1e-13 sits below
# the f32 floor, so that row falls back).  At refine 0 the V-cycle is the
# exact coarse solve and one f32 iteration leaves only rounding noise in
# the residual, so f32 iteration counts are compared at refine 1.
SOLVE_CASES = {
    "f64-mixed-forms": (
        "f64", 1, 1, _mixed_batch(_NE1),
        [TR, (0.0, 1e-3, -2e-2), (0.0, 0.0, -5e-3)], [1e-6, 1e-8, 1e-10],
    ),
    "f64-p2": ("f64", 1, 2, [MATS, MATS_B], [TR, (0.0, 0.0, -2e-2)], 1e-10),
    "mixed": ("mixed", 0, 1, [MATS, MATS_C], [TR, (0.0, 5e-3, -5e-3)], 1e-8),
    "mixed-forms": (
        "mixed", 1, 1, _mixed_batch(_NE1),
        [TR, (0.0, 1e-3, -2e-2), (0.0, 0.0, -5e-3)], [1e-6, 1e-8, 1e-10],
    ),
    "f32-forms": (
        "f32", 1, 1, _mixed_batch(_NE1),
        [TR, (0.0, 1e-3, -2e-2), (0.0, 0.0, -5e-3)], [1e-4, 1e-5, 1e-13],
    ),
}


@pytest.fixture(scope="module")
def reference_results():
    """The reference's results per case, each solved once."""
    out = {}
    for name, (prec, refine, p, mats, trs, tols) in SOLVE_CASES.items():
        solver = RefSolver(
            ref_mesh.beam_hex(), refine, p, precision=prec, maxiter=100
        )
        out[name] = solver.solve(mats, np.asarray(trs), tols)
    return out


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_matches_reference(reference_results, case):
    prec, refine, p, mats, trs, tols = SOLVE_CASES[case]
    ref = reference_results[case]
    res = _solver(refine, p, prec, maxiter=100).solve(mats, np.asarray(trs), tols)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(res.fallback.numpy(), np.asarray(ref.fallback))
    assert bool(res.converged.all())
    assert res.x.numpy().dtype == np.asarray(ref.x).dtype
    _close(res.x, ref.x, X_RTOL[prec])
    rel = (res.final_norm / res.initial_norm).numpy()
    assert (rel <= np.broadcast_to(tols, rel.shape)).all()


def test_stall_detector_armed_only_for_reduced_policies():
    assert BatchedGMGSolver(beam_hex(), 0, 1, device="cpu").stall_iters == 0
    assert BatchedGMGSolver(beam_hex(), 0, 1, precision="f32", device="cpu").stall_iters > 0
    assert BatchedGMGSolver(beam_hex(), 0, 1, precision="mixed", device="cpu").stall_iters > 0


def test_solver_level_stagnation_falls_back_to_f64():
    """A tolerance below the f32 residual floor stalls (or audits as
    dishonest): the same rows as the reference's fall back, the merged
    result is f64 and the fallback rows pay both passes."""
    mats, trs, tols = [MATS, MATS], np.asarray([TR, TR]), [1e-4, 1e-13]
    ref = RefSolver(ref_mesh.beam_hex(), 0, 1, precision="f32").solve(mats, trs, tols)
    s32 = _solver(0, 1, "f32")
    res = s32.solve(mats, trs, tols)
    np.testing.assert_array_equal(res.fallback.numpy(), np.asarray(ref.fallback))
    np.testing.assert_array_equal(res.stalled.numpy(), np.asarray(ref.stalled))
    assert res.fallback.tolist() == [False, True]
    assert bool(res.converged.all())
    assert res.x.dtype == torch.float64 and res.final_norm.dtype == torch.float64
    assert int(res.iterations[1]) > int(res.iterations[0])
    # the row's total is its f32 pass plus its f64 re-solve, whose x is
    # merged as it is (the twin sees the f32-rounded tractions and tolerances)
    twin = s32._f64_fallback_solver()
    assert twin.precision.name == "f64" and twin.stall_iters == 0
    as32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    alone = twin.solve([MATS], as32(trs[1:]), as32([1e-13]))
    assert int(res.iterations[1]) > int(alone.iterations[0])
    assert torch.equal(res.x[1], alone.x[0])


@pytest.mark.parametrize("row", [0, 1])
def test_batched_rows_match_solve_beam(row):
    """A dict row and a per-element field row of a batch against the port's
    single solve of that scenario (the field restricted to the coarser
    levels the same way): same iterations, x within 1e-10 of max |x|."""
    sv = _ref_start_vectors(1, 2)
    ne = beam_hex().refined().nelem
    mats = [MATS, _field(ne, 7)]
    trs = np.asarray([TR, (0.0, 1e-3, -2e-2)])
    res = _solver(1, 2).solve(mats, trs, [1e-6, 1e-8])
    one = solve_beam(
        2, 1, materials=mats[row], traction=tuple(trs[row]), rel_tol=[1e-6, 1e-8][row],
        device="cpu", start_vectors=[torch.from_numpy(v) for v in sv], keep_solution=True,
    )
    assert int(res.iterations[row]) == one.iterations
    _close(res.x[row], one.x.numpy(), 1e-10)


def test_hierarchy_rejects_fields_off_the_fine_mesh():
    with pytest.raises(ValueError, match="finest mesh"):
        build_hierarchy(beam_hex(), 1, 1, materials=_field(8, 0), device="cpu")


# -- properties within the port -------------------------------------------------


@pytest.fixture(scope="module")
def small():
    return _solver(1, 1, maxiter=100)


def test_pad_scenarios_rows_are_born_converged(small):
    mats, trs, rel, n_real = small.pad_scenarios([MATS, MATS_B], [TR, TR], 1e-8, n=4)
    assert n_real == 2 and len(mats) == 4 and mats[3] is MATS
    res = small.solve(mats, trs, rel)
    assert res.iterations.tolist()[2:] == [0, 0]
    assert res.converged.tolist() == [True] * 4
    assert not bool(res.x[2:].any())
    assert small.pad_batch(5) == 5


def test_dict_equals_piecewise_constant_field_bitwise(small):
    lam = np.where(small.fine_space.mesh.attributes() == 1, 50.0, 1.0)
    mu = lam.copy()
    a = small.solve([MATS, MATS_B], [TR, TR], 1e-8)
    b = small.solve([(lam, mu), MATS_B], [TR, TR], 1e-8)
    assert torch.equal(a.x, b.x) and torch.equal(a.iterations, b.iterations)
    # the fine field restricted to every coarser level: exact tree average
    lv, _ = small.pack_materials([(lam, mu)])
    for level in range(len(small.spaces)):
        got = small._restrict_field(lv, level)
        want = material_fields(small.spaces[level].mesh, MATS)[0]
        assert torch.equal(got[0], torch.as_tensor(want))


def _prepared(solver, mats):
    lam, mu = solver.pack_materials(mats)
    s = len(mats)
    return solver.prepare(lam, mu, np.ones(s, bool), solver.empty_prep(s))


def test_chunked_resumption_is_bitwise(small):
    mats = [MATS, MATS_B, _field(_NE1, 2)]
    trs = np.asarray([TR, (0.0, 1e-3, -2e-2), (0.0, 0.0, -5e-3)])
    tols = [1e-6, 1e-8, 1e-10]
    prep = _prepared(small, mats)
    ones = np.ones(3, bool)
    whole, consumed = small.run_chunk(
        trs, tols, ones, small.empty_state(3), prep, 1000, do_reset=True
    )
    assert torch.equal(consumed, whole.iters) and not bool(whole.active.any())
    state, _ = small.run_chunk(trs, tols, ones, small.empty_state(3), prep, 3, do_reset=True)
    chunks = 1
    while bool(state.active.any()):
        prev = state.iters
        state, consumed = small.run_chunk(trs, tols, ~ones, state, prep, 3)
        assert torch.equal(consumed, state.iters - prev)
        chunks += 1
    assert chunks > 2
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state, f.name), getattr(whole, f.name)), f.name
    # k1 + k2 == (k1 + k2), and the step program agrees with solve()
    k1, _ = small.run_chunk(trs, tols, ones, small.empty_state(3), prep, 2, do_reset=True)
    k12, _ = small.run_chunk(trs, tols, ~ones, k1, prep, 5)
    once, _ = small.run_chunk(trs, tols, ones, small.empty_state(3), prep, 7, do_reset=True)
    assert torch.equal(k12.x, once.x) and torch.equal(k12.iters, once.iters)
    res = small.solve(mats, trs, tols)
    assert torch.equal(res.iterations, whole.iters)
    _close(whole.x, res.x.numpy(), 1e-12)


def test_masked_refill_leaves_other_rows_bitwise(small):
    mats = [MATS, MATS_B, _field(_NE1, 2)]
    trs = np.asarray([TR, (0.0, 1e-3, -2e-2), (0.0, 0.0, -5e-3)])
    prep = _prepared(small, mats)
    ones = np.ones(3, bool)
    state, _ = small.run_chunk(trs, 1e-10, ones, small.empty_state(3), prep, 3, do_reset=True)
    # refill row 1 with new materials and traction while rows 0, 2 fly on
    mask = np.array([False, True, False])
    mats2 = [MATS, MATS_C, mats[2]]
    trs2 = trs.copy()
    trs2[1] = (0.0, -2e-3, 5e-3)
    lam2, mu2 = small.pack_materials(mats2)
    prep2 = small.prepare(lam2, mu2, mask, prep)
    for key in ("lam_w", "mu_w", "dinv", "lmax"):
        for old, new in zip(prep[key], prep2[key]):
            assert torch.equal(old.reshape(3, -1)[[0, 2]], new.reshape(3, -1)[[0, 2]])
    assert torch.equal(prep["chol"][[0, 2]], prep2["chol"][[0, 2]])
    assert not torch.equal(prep["mu_w"][-1], prep2["mu_w"][-1])  # row 1 moved
    refilled, _ = small.run_chunk(trs2, 1e-10, mask, state, prep2, 4, do_reset=True)
    untouched, _ = small.run_chunk(trs, 1e-10, ~ones, state, prep, 4)
    for f in dataclasses.fields(state):
        a, b = getattr(refilled, f.name), getattr(untouched, f.name)
        assert torch.equal(a[[0, 2]], b[[0, 2]]), f.name
    assert int(refilled.iters[1]) == 4
    # the refilled row finishes where a fresh solve of its scenario does
    while bool(refilled.active.any()):
        refilled, _ = small.run_chunk(trs2, 1e-10, ~ones, refilled, prep2, 4)
    fresh = small.solve(mats2, trs2, 1e-10)
    assert int(refilled.iters[1]) == int(fresh.iterations[1])
    _close(refilled.x[1], fresh.x[1].numpy(), 1e-10)


def test_pack_materials_rejects_bad_entries(small):
    ne = small.fine_space.nelem
    with pytest.raises(ValueError, match="scenario 1 materials: missing mesh attributes"):
        small.pack_materials([MATS, {1: (1.0, 1.0)}])
    with pytest.raises(ValueError, match=r"lam_e\[3\]"):
        lam = np.ones(ne)
        lam[3] = -1.0
        small.pack_materials([(lam, np.ones(ne))])
    with pytest.raises(TypeError, match="LIST of per-scenario entries"):
        small.pack_materials([np.ones((2, ne))])
    with pytest.raises(ValueError, match="elements per row"):
        small.prepare(torch.ones((1, 3)), torch.ones((1, 3)), [True], small.empty_prep(1))


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedGMGSolver(beam_hex(), 0, 1)


def test_mixed_bf16_and_bad_start_vectors_raise():
    # mixed-bf16 is accepted now: its leaves carry the policy's dtypes
    s = BatchedGMGSolver(beam_hex(), 0, 1, precision="mixed-bf16", device="cpu")
    prep = s.empty_prep(2)
    assert prep["lam_w"][0].dtype == torch.bfloat16
    assert prep["chol"].dtype == torch.float32
    assert prep["lam_w_solve"].dtype == torch.float64
    with pytest.raises(ValueError, match="smoothed levels"):
        BatchedGMGSolver(beam_hex(), 1, 1, device="cpu", start_vectors=[])
