"""The ``mixed-bf16`` precision policy on the port, on the CPU: an f64 outer
PCG over a bfloat16 V-cycle whose PAop applies run the kernel's plain
bfloat16 version, with the coarse factor in f32.

* The plain bfloat16 PAop against the reference's Pallas kernel in
  interpret mode on the same bfloat16 x_e/lam_w/mu_w (p in {1, 2, 4}, NE in
  {1, 5}).  The reference rounds every contraction, and its tables, to
  bfloat16; the port takes f32 tables and rounds y once, so it is held to
  the f64 apply on the same inputs within one bfloat16 rounding (2^-8 of
  max |y|), closer than the reference, and to the reference within
  ``REF_TOL`` of max |y|.
* ``solve_beam`` against the reference's at (p, refine) = (1, 1) and (2, 0)
  from the reference's bfloat16 power-iteration start vectors: iterations
  within 1 of the reference's (the port's f32 coarse factor, f32 tables
  and single rounding move them), within the reference's bound for
  reduced policies (1.3 x f64 + 1), x within ``X_TOL`` of the port's f64 x.
* The batched solver: f32 ``chol``, bfloat16 V-cycle leaves; every row
  converged with the f64 true residual (M-norm, from scratch) below its
  tolerance; rows within 1 of ``solve_beam`` of their scenario; chunked
  runs and a masked refill bitwise.
* The reference's batched ``mixed-bf16`` probes its coarse matrix through
  the bfloat16 operator and factors a matrix that is not positive
  definite: NaN factor, NaN norms, 0 iterations.  The port's rows converge
  on the same inputs.
* The service (``solve`` and ``solve_continuous``), a crash and restore
  under the policy (bitwise), and ``serve_solve --precision mixed-bf16``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.kernels.pa_elasticity import ops as ref_ops
from repro.launch.solve import solve_beam as ref_solve_beam
from repro.solvers.batched import BatchedGMGSolver as RefBatchedGMGSolver
from repro_torch.core.basis import basis_tables
from repro_torch.core.operators import ElasticityOperator
from repro_torch.fem.mesh import beam_hex
from repro_torch.fem.space import H1Space
from repro_torch.kernels.pa_elasticity import ops
from repro_torch.launch import serve_solve
from repro_torch.launch.solve import solve_beam
from repro_torch.serve import ElasticityService, ServiceRecovery, SolveRequest
from repro_torch.solvers.batched import BatchedGMGSolver, _dots, bpcg
from repro_torch.solvers.cg import pcg
from repro_torch.solvers.coarse import assembled_coarse_matrix, make_coarse_solver
from repro_torch.solvers.gmg import build_hierarchy, hierarchy_spaces

from tests.faultinject import FaultInjector, SimulatedCrash, run_schedule

BF16 = torch.bfloat16
REF_TOL = 1e-2  # port vs reference, of max |y| (measured <= 6.7e-3)
ONE_ROUNDING = 2.0 ** -8  # port vs f64 on the same inputs, of max |y|
X_TOL = 1e-6  # mixed-bf16 x vs f64 x at rel_tol 1e-6, of max |x|
MATS = {1: (50.0, 50.0), 2: (1.0, 1.0)}
MATS_B = {1: (80.0, 60.0), 2: (2.0, 1.0)}
TR = (0.0, 0.0, -1e-2)
# Sheared box: J = A diag(h/2), J^{-1} non-diagonal.
JINV = np.linalg.inv(
    np.array([[1.0, 0.2, 0.1], [0.05, 1.0, 0.3], [0.1, 0.0, 1.0]]) @ np.diag([0.25, 0.5, 0.5])
)


# -- the PAop plain bfloat16 version ---------------------------------------------


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(BF16)


@functools.lru_cache(maxsize=None)
def _paop_case(p):
    """(x, lam, mu) rounded to bfloat16 at NE = 5, the reference kernel's
    bfloat16 output on them, and the f64 apply on them."""
    tb = basis_tables(p)
    d, q = tb.d1d, tb.q1d
    rng = np.random.default_rng(300 + p)
    x, lam, mu = (
        _bf16(rng.standard_normal((5, 3, d, d, d))),
        _bf16(rng.random((5, q, q, q)) + 0.5),
        _bf16(rng.random((5, q, q, q)) + 0.5),
    )
    as_jnp = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    y_ref = ref_ops.pa_elasticity(
        as_jnp(x), as_jnp(lam), as_jnp(mu),
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (JINV, tb.B, tb.G)),
        lane="interpret",
    )
    y64 = ops.pa_elasticity(
        x.double(), lam.double(), mu.double(),
        *(torch.as_tensor(a, dtype=torch.float64) for a in (JINV, tb.B, tb.G)),
    )
    return (x, lam, mu), np.asarray(y_ref.astype(jnp.float32)).astype(np.float64), y64.numpy()


@pytest.mark.parametrize("ne", [1, 5])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_bf16_paop_plain_matches_reference(p, ne):
    (x, lam, mu), y_ref, y64 = _paop_case(p)
    tb = basis_tables(p)
    tables = (torch.as_tensor(a, dtype=torch.float32) for a in (JINV, tb.B, tb.G))
    before = ops.counts["pa_elasticity"].plain_calls
    y = ops.pa_elasticity(x[:ne], lam[:ne], mu[:ne], *tables)
    assert ops.counts["pa_elasticity"].plain_calls == before + 1
    assert y.dtype == BF16 and y.shape == x[:ne].shape
    y = y.double().numpy()
    y_ref, y64 = y_ref[:ne], y64[:ne]
    scale = np.abs(y64).max()
    port_err = np.abs(y - y64).max()
    assert port_err <= ONE_ROUNDING * scale
    assert port_err <= np.abs(y_ref - y64).max()
    assert np.abs(y - y_ref).max() <= REF_TOL * scale


def test_bf16_wrapper_takes_f32_tables():
    tb = basis_tables(2)
    x = torch.zeros((2, 3, 3, 3, 3), dtype=BF16)
    w = torch.ones((2, 4, 4, 4), dtype=BF16)
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in (np.eye(3), tb.B, tb.G)]
    assert ops.TABLE_DTYPE[BF16] == torch.float32
    assert not ops.pa_elasticity(x, w, w, *f32).any()
    with pytest.raises(ValueError, match="jinv is torch.bfloat16 on cpu, expected torch.float32"):
        ops.pa_elasticity(x, w, w, *(t.to(BF16) for t in f32))
    with pytest.raises(ValueError, match="runs only on CUDA tensors"):
        ops.launch_baseline(x, w, w, *f32)


# -- operator, space, coarse level -------------------------------------------------


def test_bf16_operator_fields_tables_and_coarse_factor():
    sp = H1Space(beam_hex(), 1)
    op = ElasticityOperator(sp, materials=MATS, dtype=BF16, device="cpu")
    assert (op.lam_w.dtype, op.mu_w.dtype, op.jinv.dtype, op.B.dtype) == (
        BF16, BF16, torch.float32, torch.float32)
    assert op.diagonal().dtype == BF16
    # the weighted fields are the f32 ones rounded once
    f32 = ElasticityOperator(sp, materials=MATS, dtype=torch.float32, device="cpu")
    assert torch.equal(op.lam_w, f32.lam_w.to(BF16))
    # E -> L sums in a fixed order: bitwise repeatable
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((sp.nscalar, 3))).to(BF16)
    y = op.apply(x)
    assert y.dtype == BF16 and torch.equal(y, op.apply(x))
    # the coarse matrix and factor in f32, the solve entered and left by casts
    assert assembled_coarse_matrix(op).dtype == torch.float32
    solve = make_coarse_solver(op)
    b = torch.where(op.ess_mask, 0.0, x)
    xs = solve(b)
    assert xs.dtype == BF16
    assert torch.equal(xs, make_coarse_solver(op.with_dtype(torch.float32))(b.float()).to(BF16))
    fields = (np.full(sp.nelem, 3.0), np.full(sp.nelem, 2.0))
    probed = ElasticityOperator(sp, materials=fields, dtype=BF16, device="cpu")
    assert make_coarse_solver(probed)(b).dtype == BF16


# -- flexible PCG ---------------------------------------------------------------------


def test_flexible_pcg_stops_unconverged_on_an_indefinite_preconditioner():
    a = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    b = torch.ones(4, dtype=torch.float64)
    A = lambda v: a * v  # noqa: E731
    good = pcg(A, b, M=lambda r: r / a, rel_tol=1e-12, flexible=True)
    assert good.converged and good.iterations == 1
    bad = pcg(A, b, M=lambda r: -r, rel_tol=1e-6, flexible=True)
    assert not bad.converged
    rows = bpcg(lambda v: a * v, torch.stack([b, b]), M=lambda r: r * torch.tensor(
        [[1.0], [-1.0]], dtype=torch.float64), rel_tol=1e-6, flexible=True, maxiter=50)
    assert rows.converged.tolist() == [True, False]
    assert rows.stalled.tolist() == [False, True]


# -- solve_beam against the reference ------------------------------------------------


def _ref_start_vectors(refine, p, dtype):
    key = jax.random.PRNGKey(1234)
    return [
        torch.from_numpy(np.asarray(
            jax.random.normal(key, (sp.nscalar, 3), dtype=dtype)).astype(np.float64))
        for sp in hierarchy_spaces(beam_hex(), refine, p)[1:]
    ]


@pytest.fixture(scope="module")
def reference_solves():
    return {(p, r): ref_solve_beam(p, r, assembly="paop", precision="mixed-bf16")
            for p, r in ((1, 1), (2, 0))}


@pytest.mark.parametrize("p,refine", [(1, 1), (2, 0)])
def test_bf16_solve_beam_matches_reference(reference_solves, p, refine):
    ref = reference_solves[p, refine]
    ops.reset_counts()
    rep = solve_beam(
        p, refine, precision="mixed-bf16", device="cpu", keep_solution=True,
        start_vectors=_ref_start_vectors(refine, p, jnp.bfloat16),
    )
    assert ops.counts["pa_elasticity"].plain_calls > 0
    assert ops.counts["pa_elasticity"].launches == 0
    f64 = solve_beam(
        p, refine, device="cpu", keep_solution=True,
        start_vectors=_ref_start_vectors(refine, p, jnp.float64),
    )
    assert rep.converged and rep.final_rel_norm <= 1e-6 and rep.precision == "mixed-bf16"
    assert ref.final_rel_norm <= 1e-6
    assert abs(rep.iterations - ref.iterations) <= 1, (rep.iterations, ref.iterations)
    assert rep.iterations <= int(1.3 * f64.iterations) + 1
    assert rep.x.dtype == torch.float64
    scale = float(f64.x.abs().max())
    assert float((rep.x - f64.x).abs().max()) <= X_TOL * scale


# -- the batched solver --------------------------------------------------------------


def _field(nelem, seed):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(0.0, 0.5, nelem), rng.lognormal(0.0, 0.5, nelem))


@pytest.fixture(scope="module")
def bf16_solver():
    return BatchedGMGSolver(beam_hex(), 1, 1, precision="mixed-bf16", device="cpu",
                            maxiter=100)


def _scenarios(solver):
    mats = [MATS, MATS_B, _field(solver.fine_space.nelem, 2)]
    trs = np.asarray([TR, (0.0, 1e-3, -2e-2), (0.0, 0.0, -5e-3)])
    return mats, trs, np.asarray([1e-6, 1e-8, 1e-6])


def _f64_rel(mats, trs, x):
    """sqrt((M r, r) / (M b, b)) with r = b - A x, operator, preconditioner
    and arithmetic at f64, from scratch."""
    s64 = BatchedGMGSolver(beam_hex(), 1, 1, device="cpu")
    s = len(mats)
    lam, mu = s64.pack_materials(mats)
    prep = s64.prepare(lam, mu, np.ones(s, bool), s64.empty_prep(s))
    _, _, A, M = s64._build_from_prep(prep)
    b = s64._rhs(torch.as_tensor(trs))
    r = b - A(x)
    return torch.sqrt(_dots(M(r), r) / _dots(M(b), b))


def test_bf16_batched_prep_rows_and_audit(bf16_solver):
    s = bf16_solver
    mats, trs, tols = _scenarios(s)
    lam, mu = s.pack_materials(mats)
    prep = s.prepare(lam, mu, np.ones(3, bool), s.empty_prep(3))
    assert prep["chol"].dtype == torch.float32 and bool(prep["chol"].isfinite().all())
    for key in ("lam_w", "mu_w", "dinv", "lmax"):
        assert all(leaf.dtype == BF16 for leaf in prep[key]), key
    assert prep["lam_w_solve"].dtype == torch.float64
    res = s.solve(mats, trs, tols)
    assert bool(res.converged.all()) and not bool(res.fallback.any())
    assert res.x.dtype == torch.float64
    assert bool((_f64_rel(mats, trs, res.x) <= torch.as_tensor(tols)).all())
    for i, (m, t, tol) in enumerate(zip(mats, trs, tols)):
        rep = solve_beam(1, 1, precision="mixed-bf16", device="cpu", materials=m,
                         traction=tuple(t), rel_tol=float(tol))
        assert abs(rep.iterations - int(res.iterations[i])) <= 1, (i, rep.iterations)


def test_bf16_batched_chunks_and_refill_are_bitwise(bf16_solver):
    s = bf16_solver
    mats, trs, tols = _scenarios(s)
    lam, mu = s.pack_materials(mats)
    ones = np.ones(3, bool)
    prep = s.prepare(lam, mu, ones, s.empty_prep(3))
    whole, _ = s.run_chunk(trs, tols, ones, s.empty_state(3), prep, 1000, do_reset=True)
    state, _ = s.run_chunk(trs, tols, ones, s.empty_state(3), prep, 2, do_reset=True)
    after2 = state
    while bool(state.active.any()):
        state, _ = s.run_chunk(trs, tols, ~ones, state, prep, 2)
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state, f.name), getattr(whole, f.name)), f.name
    mask = np.array([False, True, False])
    lam2, mu2 = s.pack_materials([mats[0], {1: (9.0, 9.0), 2: (1.0, 3.0)}, mats[2]])
    prep2 = s.prepare(lam2, mu2, mask, prep)
    for key in ("lam_w", "mu_w", "dinv", "lmax"):
        for old, new in zip(prep[key], prep2[key]):
            assert torch.equal(old.reshape(3, -1)[[0, 2]], new.reshape(3, -1)[[0, 2]])
    assert torch.equal(prep["chol"][[0, 2]], prep2["chol"][[0, 2]])
    refilled, _ = s.run_chunk(trs, tols, mask, after2, prep2, 3, do_reset=True)
    untouched, _ = s.run_chunk(trs, tols, ~ones, after2, prep, 3)
    for f in dataclasses.fields(state):
        a, b = getattr(refilled, f.name), getattr(untouched, f.name)
        assert torch.equal(a[[0, 2]], b[[0, 2]]), f.name
    # the bfloat16 leaves go to the host as bit patterns and back bitwise
    host = s.prep_to_host(prep2)
    assert host["lam_w0"].dtype == np.uint16 and host["chol"].dtype == np.float32
    back = s.prep_from_host(host)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(prep2["mu_w"], back["mu_w"]))
    assert torch.equal(back["chol"], prep2["chol"])


def test_reference_bf16_batched_is_nan_where_the_port_converges():
    mats, trs = [MATS, MATS], [(0.0, 0.0, -1e-2), (0.0, 0.0, -2e-2)]
    ref = RefBatchedGMGSolver(ref_beam_hex(), 0, 1, precision="mixed-bf16")
    lam, mu = ref.pack_materials(mats)
    chol = np.asarray(ref.prepare(lam, mu, np.ones(2, bool), ref.empty_prep(2))["chol"])
    assert np.isnan(chol).any()
    out = ref.solve(mats, trs, 1e-6)
    assert np.isnan(np.asarray(out.initial_norm)).all()
    assert np.asarray(out.iterations).tolist() == [0, 0]
    assert not np.asarray(out.converged).any()
    port = BatchedGMGSolver(beam_hex(), 0, 1, precision="mixed-bf16", device="cpu")
    res = port.solve(mats, trs, 1e-6)
    assert bool(res.converged.all()) and bool(res.initial_norm.isfinite().all())
    assert bool((res.final_norm <= 1e-6 * res.initial_norm).all())


# -- service, recovery, CLI ---------------------------------------------------------


def _req(i):
    return SolveRequest(
        p=1, refine=0, materials=(MATS, MATS_B, {1: (9.0, 9.0), 2: (1.0, 3.0)})[i % 3],
        traction=(0.0, 2e-3 * (i % 2), -1e-2 * (1.0 + 0.25 * i)),
        rel_tol=1e-8 if i % 2 else 1e-6, keep_solution=True,
    )


def _service(**kw):
    return ElasticityService(device="cpu", precision="mixed-bf16", max_batch=4,
                             chunk_iters=2, **kw)


def test_bf16_service_generational_and_continuous_agree():
    reqs = [_req(i) for i in range(6)]
    gen = _service().solve(reqs)
    cont = _service().solve_continuous(reqs)
    assert [r.precision for r in gen] == ["mixed-bf16"] * 6
    assert [(r.iterations, r.converged, r.fallback) for r in gen] == [
        (r.iterations, r.converged, r.fallback) for r in cont]
    assert all(r.converged for r in gen)


def test_bf16_crash_restore_is_bitwise(tmp_path):
    schedule = [(s, _req(i)) for s, i in [(0, 0), (0, 1), (0, 2), (1, 3), (2, 4)]]
    base = {r.ticket: r for r in run_schedule(_service(), schedule)}
    svc = _service()
    rec = ServiceRecovery(svc, str(tmp_path), every=1)
    FaultInjector(svc).arm("mid-chunk", at_step=2)
    with pytest.raises(SimulatedCrash):
        run_schedule(svc, schedule, rec)
    svc2 = _service()
    rec2 = ServiceRecovery(svc2, str(tmp_path), every=1)
    assert rec2.restore()
    got = {r.ticket: r for r in run_schedule(svc2, schedule, rec2)}
    assert set(got) == set(base)
    for t in base:
        a, b = base[t], got[t]
        assert (a.iterations, a.converged, a.precision, a.final_rel_norm) == (
            b.iterations, b.converged, b.precision, b.final_rel_norm), t
        np.testing.assert_array_equal(a.x, b.x)


def test_bf16_serve_solve_cli(capsys):
    serve_solve.main(["--device", "cpu", "--precision", "mixed-bf16", "--n-requests", "3",
                      "--max-batch", "4", "--p", "1", "--refine", "0"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "p1/r0" in ln]
    assert len(lines) == 3 and all("mixed-bf16" in ln and "True" in ln for ln in lines)


def test_bf16_hierarchy_builds_at_policy_dtypes():
    g = build_hierarchy(beam_hex(), 1, 2, materials=MATS, dtype=BF16, device="cpu")
    assert all(lv.operator.lam_w.dtype == BF16 for lv in g.levels)
    assert all(lv.smoother.dinv.dtype == BF16 for lv in g.levels[1:])
    assert all(t.px.dtype == BF16 for t in g.transfers)
    r = torch.ones((g.fine.space.nscalar, 3), dtype=BF16)
    assert g(r).dtype == BF16 and bool(g(r).isfinite().all())
