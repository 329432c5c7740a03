"""The port's CUDA kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip without a card.  This
file imports neither jax nor the reference package, so on the card it
runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.basis import basis_tables
from repro_torch.kernels.pa_elasticity import ops
from repro_torch.kernels.pa_elasticity.ref import paop_ref
from repro_torch.launch.solve import solve_beam
from repro_torch.fem.mesh import beam_hex
from repro_torch.solvers.gmg import hierarchy_spaces

TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-4, 2e-5)}  # rtol, atol / max|ref|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _args(p, ne, dtype, device):
    tb = basis_tables(p)
    g = torch.Generator().manual_seed(p)
    d, q = tb.d1d, tb.q1d
    jinv = torch.eye(3, dtype=dtype) + 0.1 * torch.randn((3, 3), generator=g, dtype=dtype)
    args = [
        torch.randn((ne, 3, d, d, d), generator=g, dtype=dtype),
        torch.rand((ne, q, q, q), generator=g, dtype=dtype) + 0.5,
        torch.rand((ne, q, q, q), generator=g, dtype=dtype) + 0.5,
        jinv,
        torch.as_tensor(tb.B, dtype=dtype),
        torch.as_tensor(tb.G, dtype=dtype),
    ]
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", ops.SUPPORTED_P)
def test_kernel_matches_plain_on_card(card, p, dtype):
    rtol, atol = TOL[dtype]
    for ne in (1, 7, 300):
        args = _args(p, ne, dtype, card)
        before = ops.counts["pa_elasticity"].launches
        y = ops.pa_elasticity(*args)
        assert ops.counts["pa_elasticity"].launches == before + 1
        ref = paop_ref(*args)
        torch.testing.assert_close(y, ref, rtol=rtol, atol=atol * float(ref.abs().max()))


@pytest.mark.cuda
def test_probe_on_card(card):
    ops.check_probe(card)
    x = torch.randn(1000, device=card)
    assert torch.equal(ops.probe(x), 2 * x)


@pytest.mark.cuda
def test_small_solve_on_card_matches_cpu(card):
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    g = torch.Generator().manual_seed(0)
    sv = [torch.randn((sp.nscalar, 3), generator=g, dtype=torch.float64) for sp in spaces[1:]]
    ops.reset_counts()
    a = solve_beam(2, 1, device=card, start_vectors=sv, keep_solution=True)
    assert ops.counts["pa_elasticity"].plain_calls == 0
    assert ops.counts["pa_elasticity"].launches > 0
    b = solve_beam(2, 1, device="cpu", start_vectors=sv, keep_solution=True)
    assert a.iterations == b.iterations and a.converged
    scale = float(b.x.abs().max())
    torch.testing.assert_close(a.x.cpu(), b.x, rtol=1e-10, atol=1e-10 * scale)
    # the deterministic scatter makes a repeat on the card bitwise equal
    c = solve_beam(2, 1, device=card, start_vectors=sv, keep_solution=True)
    assert torch.equal(a.x, c.x)
