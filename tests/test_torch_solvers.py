"""Port's solver building blocks vs the reference's, on the CPU in float64:
MFEM-style PCG (including its den <= 0 stop and the zero-RHS exit), the
power iteration and Chebyshev smoother from an injected start vector, and
the coarse Cholesky solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operators import ElasticityOperator as RefOperator
from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.fem.space import H1Space as RefSpace
from repro.solvers.cg import pcg as ref_pcg
from repro.solvers.chebyshev import ChebyshevSmoother as RefSmoother
from repro.solvers.coarse import make_coarse_solver as ref_coarse
from repro_torch import convert
from repro_torch.core.operators import ElasticityOperator
from repro_torch.fem.space import H1Space
from repro_torch.solvers.cg import pcg
from repro_torch.solvers.chebyshev import ChebyshevSmoother, power_iteration_lmax
from repro_torch.solvers.coarse import make_coarse_solver


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n), rng.standard_normal(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcg_matches_reference(seed):
    A, b = _spd(24, seed)
    dinv = 1.0 / np.diag(A)
    ref = ref_pcg(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
        M=lambda r: jnp.asarray(dinv) * r, rel_tol=1e-10,
    )
    At, dt = torch.from_numpy(A), torch.from_numpy(dinv)
    got = pcg(lambda v: At @ v, torch.from_numpy(b), M=lambda r: dt * r, rel_tol=1e-10)
    assert got.iterations == int(ref.iterations)
    assert got.converged and bool(ref.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-10)
    np.testing.assert_allclose(got.final_norm, float(ref.final_norm), rtol=1e-6)


def test_pcg_stops_on_non_positive_curvature():
    b = torch.ones(5, dtype=torch.float64)
    res = pcg(lambda v: -v, b)  # den = (d, A d) < 0 at the first step
    assert res.iterations == 0 and not res.converged
    assert torch.equal(res.x, torch.zeros_like(b))  # no step taken


def test_pcg_zero_rhs_exits_converged():
    res = pcg(lambda v: 2 * v, torch.zeros(4, dtype=torch.float64))
    assert res.iterations == 0 and res.converged and res.initial_norm == 0.0


@pytest.fixture(scope="module")
def level():
    """A p=2 level on the once-refined beam: the reference operator and
    the port's, plus the reference's power-iteration start vector."""
    rm = ref_beam_hex().refined()
    ref = RefOperator(RefSpace(rm, 2), assembly="paop")
    op = ElasticityOperator(H1Space(convert.hex_mesh(rm), 2), device="cpu")
    v0 = jax.random.normal(jax.random.PRNGKey(1234), (ref.space.nscalar, 3), jnp.float64)
    return ref, op, np.array(v0)


def test_power_iteration_and_smoother_match_reference(level):
    ref, op, v0 = level
    rcop, cop = ref.constrained(), op.constrained()
    rsm = RefSmoother.setup(
        rcop, rcop.diagonal(), shape=(ref.space.nscalar, 3), dtype=jnp.float64
    )
    sm = ChebyshevSmoother.setup(cop, cop.diagonal(), v0=torch.from_numpy(v0))
    np.testing.assert_allclose(float(sm.lmax), float(rsm.lmax), rtol=1e-12)
    lam = power_iteration_lmax(cop, sm.dinv, torch.from_numpy(v0), iters=10)
    assert float(lam) == float(sm.lmax)
    b = np.random.default_rng(5).standard_normal((ref.space.nscalar, 3))
    ref_x = np.asarray(rsm(jnp.asarray(b)))
    got = sm(torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref_x, rtol=1e-11, atol=1e-11 * np.abs(ref_x).max())
    ref_x2 = np.asarray(rsm(jnp.asarray(b), jnp.asarray(ref_x)))
    got2 = sm(torch.from_numpy(b), got)
    np.testing.assert_allclose(got2.numpy(), ref_x2, rtol=1e-10, atol=1e-10 * np.abs(ref_x2).max())


def test_seeded_start_vector_is_repeatable(level):
    _, op, _ = level
    cop = op.constrained()
    a = ChebyshevSmoother.setup(cop, cop.diagonal(), seed=7)
    b = ChebyshevSmoother.setup(cop, cop.diagonal(), seed=7)
    assert float(a.lmax) == float(b.lmax) > 0
    with pytest.raises(ValueError, match="start vector shape"):
        ChebyshevSmoother.setup(cop, cop.diagonal(), v0=torch.zeros(3, 3, dtype=torch.float64))


@pytest.mark.parametrize("mat", ["dict", "per_element"])
def test_coarse_cholesky_matches_reference(mat):
    rm = ref_beam_hex()
    mats = {1: (50.0, 50.0), 2: (1.0, 1.0)}
    if mat == "per_element":
        rng = np.random.default_rng(11)
        mats = (rng.uniform(1, 5, rm.nelem), rng.uniform(1, 5, rm.nelem))
    ref = RefOperator(RefSpace(rm, 1), assembly="paop", materials=mats)
    op = ElasticityOperator(
        H1Space(convert.hex_mesh(rm), 1), materials=mats, device="cpu"
    )
    b = np.random.default_rng(3).standard_normal((ref.space.nscalar, 3))
    b[np.asarray(ref.ess_mask)] = 0.0
    ref_x = np.asarray(ref_coarse(ref)(jnp.asarray(b)))
    got = make_coarse_solver(op)(torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref_x, rtol=1e-10, atol=1e-10 * np.abs(ref_x).max())
    # the solve inverts the constrained operator
    back = op.constrained()(got)
    np.testing.assert_allclose(back.numpy(), b, rtol=1e-9, atol=1e-9 * np.abs(b).max())
