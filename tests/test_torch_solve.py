"""The port's slice as a whole: the beam GMG-PCG solve vs the reference.

The reference ``solve_beam(2, 1, assembly="paop")`` runs once (module
fixture, ~15-20 s of jit).  The port runs the same solve on the CPU with
the reference's power-iteration start vectors injected
(``jax.random.normal(PRNGKey(1234), (nscalar, 3))`` per smoothed level),
so lambda_max and then the iteration count match.  Both assemble the
dict-material coarse matrix through scipy, but the operators' sums run in
other orders, so solutions are compared to rtol 1e-10, not bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import record_function

from repro.launch.solve import solve_beam as ref_solve_beam
from repro_torch import convert
from repro_torch.fem.mesh import beam_hex
from repro_torch.kernels.pa_elasticity import ops
from repro_torch.launch.solve import main, solve_beam
from repro_torch.profiling import print_profile
from repro_torch.solvers.gmg import hierarchy_spaces

P, REFINE, REL_TOL = 2, 1, 1e-6


def _reference_start_vectors():
    spaces = hierarchy_spaces(beam_hex(), REFINE, P)
    key = jax.random.PRNGKey(1234)
    return [
        np.asarray(jax.random.normal(key, (sp.nscalar, 3), dtype=jnp.float64))
        for sp in spaces[1:]
    ]


@pytest.fixture(scope="module")
def reference():
    return ref_solve_beam(P, REFINE, assembly="paop", keep_solution=True)


@pytest.fixture(scope="module")
def start_vectors():
    return convert.start_vectors(
        _reference_start_vectors(), device="cpu", dtype=torch.float64
    )


@pytest.mark.parametrize("assembly", ["paop_cuda", "paop"])
def test_solve_matches_reference(reference, start_vectors, assembly):
    ops.reset_counts()
    rep = solve_beam(
        P, REFINE, assembly=assembly, device="cpu", start_vectors=start_vectors,
        keep_solution=True, rel_tol=REL_TOL,
    )
    assert rep.iterations == reference.iterations
    assert (rep.ndof, rep.nelem) == (reference.ndof, reference.nelem)
    assert rep.converged and rep.final_rel_norm <= REL_TOL
    assert reference.final_rel_norm <= REL_TOL
    ref_x = np.asarray(reference.x)
    np.testing.assert_allclose(
        rep.x.numpy(), ref_x, rtol=1e-10, atol=1e-10 * np.abs(ref_x).max()
    )
    # On the CPU the kernel level runs its plain version, never a launch.
    assert ops.counts["pa_elasticity"].launches == 0
    assert (ops.counts["pa_elasticity"].plain_calls > 0) == (assembly == "paop_cuda")


def test_solve_is_repeatable_bitwise():
    a = solve_beam(1, 1, device="cpu", keep_solution=True)
    b = solve_beam(1, 1, device="cpu", keep_solution=True)
    assert a.iterations == b.iterations
    assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_reduced_precision_solve_converges(start_vectors, precision):
    rep = solve_beam(
        P, REFINE, device="cpu", precision=precision, start_vectors=start_vectors,
        keep_solution=True,
    )
    assert rep.converged and rep.final_rel_norm <= REL_TOL
    assert rep.precision == precision
    assert rep.x.dtype == (torch.float32 if precision == "f32" else torch.float64)


def test_pcg_jacobi_coarse_solver_converges(start_vectors):
    rep = solve_beam(
        P, REFINE, device="cpu", coarse_method="pcg_jacobi", start_vectors=start_vectors,
    )
    assert rep.converged and rep.final_rel_norm <= REL_TOL


def test_solve_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_beam(1, 0)


def test_mixed_bf16_raises():
    """The policy runs (it raised before the bfloat16 kernel existed): the
    V-cycle in bfloat16 through the kernel's plain version, the coarse
    factor in float32, the outer PCG in float64."""
    ops.reset_counts()
    rep = solve_beam(1, 0, device="cpu", precision="mixed-bf16", keep_solution=True)
    assert rep.precision == "mixed-bf16" and rep.converged
    assert rep.final_rel_norm <= REL_TOL and rep.x.dtype == torch.float64
    assert ops.counts["pa_elasticity"].plain_calls > 0
    assert ops.counts["pa_elasticity"].launches == 0


def test_start_vector_count_checked():
    with pytest.raises(ValueError, match="smoothed levels"):
        solve_beam(1, 1, device="cpu", start_vectors=[])


def test_cli_runs_on_cpu(capsys):
    main(["--p", "1", "--refine", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "iters=1" in out and "device=cpu" in out


def test_print_profile_reports_each_phase(capsys):
    def run():
        for phase in ("solve_beam.precond", "solve_beam.pcg"):
            with record_function(phase):
                torch.ones(16).cumsum(0)

    print_profile(run, prefix="solve_beam.")
    out = capsys.readouterr().out
    for phase in ("precond", "pcg"):
        assert f"[profile] solve_beam.{phase}: host" in out
