"""The paper's assembly ladder in the port vs the reference, on the CPU.

Every level of ``ASSEMBLY_LEVELS`` (``fa``, ``pa_baseline``,
``pa_sumfact``, ``pa_sumfact_voigt``, ``paop``, ``paop_cuda``) is held
against its namesake in ``src/repro/`` on the same numpy inputs: the
dense gradient table bitwise; the element operators and the operator's
``apply`` at p in {1, 2, 3} on the beam at refine 0-1, single and S=2
batched, with the per-element J^{-1} branch, to rtol 1e-12 (atol 1e-12
of max |ref|); the FA element matrix and CSR (same ``indptr``/``indices``,
data to 1e-12), its diagonal and every level's ``memory_bytes``; the
reference's ``fa`` refusals; ``solve_beam(2, 1)`` under every level (the
reference's power-iteration start vectors injected); the dict-material
coarse matrix; and a small batched solve through ``pa_sumfact_voigt``.
The port's ``paop_cuda`` is compared with the reference's ``paop`` (on
the CPU its wrapper runs the plain version)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fa as ref_fa
from repro.core import pa_baseline as ref_base
from repro.core import pa_sumfact as ref_sf
from repro.core.basis import BasisTables as RefTables
from repro.core.geometry import make_quadrature_data
from repro.core.operators import ElasticityOperator as RefOperator
from repro.fem import mesh as ref_mesh
from repro.fem.space import H1Space as RefSpace
from repro.launch.solve import solve_beam as ref_solve_beam
from repro.solvers.batched import BatchedGMGSolver as RefSolver
from repro.solvers.coarse import make_coarse_solver as ref_coarse_solver
from repro_torch import convert
from repro_torch.core import fa
from repro_torch.core import pa_baseline as base
from repro_torch.core import pa_sumfact as sf
from repro_torch.core.basis import basis_tables
from repro_torch.core.geometry import quadrature_geometry
from repro_torch.core.operators import (
    ASSEMBLY_LEVELS,
    DEFER_MATERIALS,
    ElasticityOperator,
    fused_level,
)
from repro_torch.fem.mesh import beam_hex
from repro_torch.fem.space import H1Space
from repro_torch.launch.solve import solve_beam
from repro_torch.solvers import BatchedGMGSolver
from repro_torch.solvers.coarse import (
    assembled_coarse_matrix,
    make_coarse_solver,
    probe_coarse_matrix,
)
from repro_torch.solvers.gmg import build_hierarchy, hierarchy_spaces

RTOL = 1e-12
MATS = {1: (50.0, 50.0), 2: (1.0, 1.0)}
MATS_B = {1: (10.0, 5.0), 2: (2.0, 2.0)}
UNFUSED = ("pa_baseline", "pa_sumfact", "pa_sumfact_voigt")
# The port's level -> the reference level it is compared with.
REF_LEVEL = {a: a for a in ASSEMBLY_LEVELS} | {"paop_cuda": "paop"}


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _ref_start_vectors(refine, p):
    key = jax.random.PRNGKey(1234)
    return [
        np.array(jax.random.normal(key, (sp.nscalar, 3), dtype=jnp.float64))
        for sp in hierarchy_spaces(beam_hex(), refine, p)[1:]
    ]


def _element_inputs(p, ne, seed):
    """Random x_e, weighted fields and a per-element J^{-1} stack."""
    tb = RefTables(p)
    d, q = tb.d1d, tb.q1d
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((ne, 3, d, d, d)),
        rng.uniform(0.5, 2.0, (ne, q, q, q)),
        rng.uniform(0.5, 2.0, (ne, q, q, q)),
        np.eye(3) + 0.1 * rng.standard_normal((ne, 3, 3)),
    )


# -- element level -------------------------------------------------------------


@pytest.mark.parametrize("p", range(1, 9))
def test_dense_grad_table_bitwise(p):
    want = ref_base._dense_grad_table_np(p)
    np.testing.assert_array_equal(base._dense_grad_table_np(p), want)
    got = base.dense_grad_table(p, dtype=torch.float64, device="cpu")
    assert got.shape == (3, (p + 2) ** 3, (p + 1) ** 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("jinv_kind", ["mesh", "per_element"])
@pytest.mark.parametrize("level", UNFUSED)
@pytest.mark.parametrize("p", [1, 2, 3])
def test_element_apply_matches_reference(p, level, jinv_kind):
    """Both J^{-1} branches: (3, 3) and (nelem, 3, 3)."""
    x, lam, mu, jinv = _element_inputs(p, 5, p)
    if jinv_kind == "mesh":
        jinv = jinv[0]
    tb = RefTables(p)
    if level == "pa_baseline":
        want = ref_base.pa_baseline_apply(
            x, lam, mu, jnp.asarray(jinv), ref_base.dense_grad_table(p)
        )
        got = base.pa_baseline_apply(
            *map(torch.from_numpy, (x, lam, mu, jinv)),
            base.dense_grad_table(p, device="cpu"),
        )
    else:
        fn = "pa_sumfact_apply" if level == "pa_sumfact" else "pa_sumfact_voigt_apply"
        want = getattr(ref_sf, fn)(x, lam, mu, jnp.asarray(jinv), tb.B, tb.G)
        got = getattr(sf, fn)(*map(torch.from_numpy, (x, lam, mu, jinv, tb.B, tb.G)))
    _close(got, want)


# -- operator level ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_apply(level, p, refine, batched):
    rm = ref_mesh.beam_hex().refined(refine)
    mats = [MATS, MATS_B] if batched else MATS
    ref = RefOperator(RefSpace(rm, p), assembly=REF_LEVEL[level], materials=mats)
    shape = ((2,) if batched else ()) + (ref.space.nscalar, 3)
    x = np.random.default_rng(10 * p + refine).standard_normal(shape)
    return x, np.asarray(jax.jit(ref.apply)(jnp.asarray(x))), ref.memory_bytes()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("level", UNFUSED)
def test_operator_apply_matches_reference(level, p, refine, batched):
    x, want, mem = _reference_apply(level, p, refine, batched)
    op = ElasticityOperator(
        H1Space(beam_hex().refined(refine), p), assembly=level,
        materials=[MATS, MATS_B] if batched else MATS, device="cpu",
    )
    assert op.nbatch == (2 if batched else None)
    _close(op.apply(torch.from_numpy(x)), want)
    assert op.memory_bytes() == mem


@pytest.mark.parametrize("level", ASSEMBLY_LEVELS)
def test_memory_bytes_and_diagonal_match_reference(level):
    rm = ref_mesh.beam_hex().refined()
    ref = RefOperator(RefSpace(rm, 2), assembly=REF_LEVEL[level], materials=MATS)
    op = ElasticityOperator(
        H1Space(beam_hex().refined(), 2), assembly=level, materials=MATS, device="cpu"
    )
    assert op.memory_bytes() == ref.memory_bytes()
    _close(op.diagonal(), ref.diagonal())
    _close(op.constrained().diagonal(), ref.constrained().diagonal())


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_fa_apply_matches_reference(p, refine):
    x, want, mem = _reference_apply("fa", p, refine, False)
    op = ElasticityOperator(
        H1Space(beam_hex().refined(refine), p), assembly="fa", device="cpu"
    )
    xt = torch.from_numpy(x)
    y = op.apply(xt)
    _close(y, want)
    assert torch.equal(op.apply(xt), y)  # fixed-order row sums
    assert op.memory_bytes() == mem


# -- full assembly ---------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 3])
def test_element_matrix_matches_reference(p):
    jinv = np.eye(3) + 0.1 * np.random.default_rng(p).standard_normal((3, 3))
    want = ref_fa.element_matrix(p, jinv, 0.7, 3.0, 2.0)
    got = fa.element_matrix(p, jinv, 0.7, 3.0, 2.0)
    assert got.shape == want.shape == (3 * (p + 1) ** 3,) * 2
    _close(got, want)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("p, refine", [(1, 0), (1, 1), (2, 0), (2, 1), (3, 0)])
def test_assemble_sparse_matches_reference(p, refine, constrained):
    rm = ref_mesh.beam_hex().refined(refine)
    rs = RefSpace(rm, p)
    ess = np.asarray(rs.essential_mask()) if constrained else None
    want = ref_fa.assemble_sparse(
        rs, make_quadrature_data(rm, rs.tables, MATS), MATS, ess_mask=ess
    )
    space = H1Space(convert.hex_mesh(rm), p)
    got = fa.assemble_sparse(
        space, quadrature_geometry(space.mesh, space.tables), MATS, ess_mask=ess,
        device="cpu",
    )
    np.testing.assert_array_equal(got.csr.indptr, want.csr.indptr)
    np.testing.assert_array_equal(got.csr.indices, want.csr.indices)
    _close(got.csr.data, want.csr.data)
    assert (got.nnz, got.n, got.memory_bytes()) == (want.nnz, want.n, want.memory_bytes())
    x = np.random.default_rng(p).standard_normal(want.n)
    _close(got.matvec(torch.from_numpy(x)), want.matvec(jnp.asarray(x)))
    assert fa.fa_memory_bytes(space) == ref_fa.fa_memory_bytes(rs)


def test_fa_refusals_match_reference():
    """Every refusal of the reference's ``fa`` level raises here too."""
    space = H1Space(beam_hex(), 1)
    rs = RefSpace(ref_mesh.beam_hex(), 1)
    ne = space.nelem
    field = (np.full(ne, 2.0), np.full(ne, 1.0))
    for mats in (DEFER_MATERIALS, [MATS, MATS_B], field):
        with pytest.raises(ValueError):
            RefOperator(rs, assembly="fa", materials=mats)
        with pytest.raises(ValueError, match="fa"):
            ElasticityOperator(space, assembly="fa", materials=mats, device="cpu")
    ref = RefOperator(rs, assembly="fa")
    op = ElasticityOperator(space, assembly="fa", device="cpu")
    lam = np.ones((2, ne))
    w = op.lam_w
    for name, args in (
        ("with_materials", (lam[0], lam[0])),
        ("with_material_weights", (w, w, None)),
        ("with_materials_rows", (lam, lam, np.ones(2, bool))),
    ):
        with pytest.raises(ValueError):
            getattr(ref, name)(*args)
        with pytest.raises(ValueError, match="matrix-free"):
            getattr(op, name)(*args)
    with pytest.raises(ValueError, match="matrix-free"):
        RefSolver(ref_mesh.beam_hex(), 0, 1, assembly="fa")
    with pytest.raises(ValueError, match="matrix-free"):
        BatchedGMGSolver(beam_hex(), 0, 1, assembly="fa", device="cpu")
    with pytest.raises(ValueError, match="unknown assembly level"):
        ElasticityOperator(space, assembly="paop_pallas", device="cpu")


def test_coarsest_level_runs_the_fused_operator():
    """The reference's level rule: the coarsest level is fused unless the
    whole hierarchy is fa; the fused level follows the device."""
    assert [fused_level(a, "cpu") for a in ASSEMBLY_LEVELS] == [
        "fa", "paop", "paop", "paop", "paop", "paop_cuda"]
    assert fused_level("pa_baseline", "cuda") == "paop_cuda"
    for a in ASSEMBLY_LEVELS:
        gmg = build_hierarchy(beam_hex(), 1, 2, assembly=a, device="cpu")
        assert [lv.operator.assembly for lv in gmg.levels] == [
            fused_level(a, "cpu"), a, a]
    s = BatchedGMGSolver(beam_hex(), 1, 2, assembly="pa_baseline", device="cpu")
    assert [op.assembly for op in s._base_ops] == ["paop", "pa_baseline", "pa_baseline"]


# -- coarse level ----------------------------------------------------------------


def test_dict_coarse_matrix_matches_reference_and_probe():
    rm = ref_mesh.beam_hex()
    ref = RefOperator(RefSpace(rm, 1), assembly="paop", materials=MATS)
    op = ElasticityOperator(H1Space(beam_hex(), 1), materials=MATS, device="cpu")
    rs = ref.space
    want = ref_fa.assemble_sparse(
        rs, make_quadrature_data(rm, rs.tables, MATS), MATS,
        ess_mask=np.asarray(ref.ess_mask),
    ).csr.toarray()
    got = assembled_coarse_matrix(op)
    _close(got, want)
    _close(got, probe_coarse_matrix(op).numpy())
    b = np.random.default_rng(3).standard_normal((rs.nscalar, 3))
    b[np.asarray(ref.ess_mask)] = 0.0
    _close(make_coarse_solver(op)(torch.from_numpy(b)),
           ref_coarse_solver(ref)(jnp.asarray(b)), 1e-10)


# -- solves ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_solve(level):
    rep = ref_solve_beam(2, 1, assembly=level, keep_solution=True)
    return rep.iterations, np.asarray(rep.x)


@pytest.mark.parametrize("level", ASSEMBLY_LEVELS)
def test_solve_matches_reference_under_every_level(level):
    iters, ref_x = _reference_solve(REF_LEVEL[level])
    sv = [torch.from_numpy(v) for v in _ref_start_vectors(1, 2)]
    rep = solve_beam(2, 1, assembly=level, device="cpu", start_vectors=sv,
                     keep_solution=True)
    assert rep.assembly == level
    assert rep.converged and rep.final_rel_norm <= 1e-6
    assert rep.iterations == iters == _reference_solve("paop")[0]
    _close(rep.x, ref_x, 1e-10)


def test_batched_solve_through_voigt_stage_matches_reference():
    mats = [MATS, MATS_B]
    trs = np.array([(0.0, 0.0, -1e-2), (0.0, 1e-2, -1e-2)])
    tols = [1e-6, 1e-8]
    ref = RefSolver(ref_mesh.beam_hex(), 1, 1, assembly="pa_sumfact_voigt").solve(
        mats, trs, tols)
    s = BatchedGMGSolver(
        beam_hex(), 1, 1, assembly="pa_sumfact_voigt", device="cpu",
        start_vectors=_ref_start_vectors(1, 1),
    )
    res = s.solve(mats, trs, tols)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    assert bool(res.converged.all())
    _close(res.x, ref.x, 1e-10)
