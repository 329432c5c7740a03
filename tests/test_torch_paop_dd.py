"""The port's domain-decomposed PAop (``repro_torch.core.paop_dd``) on
the CPU, over 1, 2, 4 and 8 virtual CPU devices: the reference's
``tests/test_paop_dd.py`` case for case, where the reference runs on its
one device.  The DD apply is held against the reference's global
``ElasticityOperator`` apply in f64 at rtol 1e-11 (the two sum shared
nodes in different orders), and every shard's data against its device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operators import ElasticityOperator as RefOperator
from repro.core.paop_dd import choose_grid as ref_choose_grid
from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.fem.space import H1Space as RefSpace
from repro_torch.core.paop_dd import SlabDecomposition, choose_grid
from repro_torch.fem.mesh import beam_hex
from repro_torch.fem.space import H1Space

NDEV = (1, 2, 4, 8)


def _dd(p: int, n: int, dtype=torch.float64) -> SlabDecomposition:
    """The once-refined beam (16 x 2 x 2 elements) over n virtual CPU
    devices."""
    return SlabDecomposition(H1Space(beam_hex().refined(), p), ("cpu",) * n, dtype=dtype)


@pytest.mark.parametrize(
    "nx, ny, n",
    [(128, 16, 256), (16, 2, 8), (8, 1, 4), (3, 3, 7), (128, 16, 4)]
    + [(16, 2, n) for n in NDEV],
)
def test_choose_grid_matches_reference(nx, ny, n):
    try:
        want = ref_choose_grid(nx, ny, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            choose_grid(nx, ny, n)
        assert str(got.value) == str(e)
        return
    assert choose_grid(nx, ny, n) == want


@pytest.mark.parametrize("n", NDEV)
@pytest.mark.parametrize("p", [1, 2, 3])
def test_dd_matches_reference_global(p, n):
    space = RefSpace(ref_beam_hex().refined(), p)
    op = RefOperator(space, assembly="paop", dtype=jnp.float64)
    x = np.random.default_rng(p).standard_normal((space.nscalar, 3))
    y_ref = np.asarray(op.apply(jnp.asarray(x)))
    dd = _dd(p, n)
    assert (dd.gx * dd.gy, len(dd.mesh)) == (n, n)
    blocks = dd.to_blocks(torch.as_tensor(x))
    assert [b.device for b in blocks] == list(dd.mesh)
    assert [b.device for b in dd.lam_blocks + dd.mu_blocks] == list(dd.mesh) * 2
    y_dd = dd.from_blocks(dd.apply_blocks(blocks)).numpy()
    np.testing.assert_allclose(y_dd, y_ref, rtol=1e-11, atol=1e-12 * np.abs(y_ref).max())


@pytest.mark.parametrize("n", NDEV)
def test_block_roundtrip_and_shared_planes(n):
    """from_blocks(to_blocks(x)) == x bitwise, and after an apply both
    copies of every shared node plane hold the same bits."""
    dd = _dd(2, n)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((dd.space.nscalar, 3)))
    assert torch.equal(dd.from_blocks(dd.to_blocks(x)), x)
    yb = dd.apply_blocks(dd.to_blocks(x))
    y = dd.from_blocks(yb)
    for ids, b in zip(dd.block_ids, yb):
        assert torch.equal(y[torch.as_tensor(ids)], b)


@pytest.mark.parametrize("n", NDEV)
def test_two_material_split_respected(n):
    """The per-shard quadrature blocks carry the 50:1 material contrast."""
    lam = torch.cat(_dd(2, n).lam_blocks).numpy()  # (nelem, Q, Q, Q)
    per_elem = lam.reshape(lam.shape[0], -1).mean(axis=1)
    assert per_elem.max() / per_elem.min() == pytest.approx(50.0, rel=1e-10)


def test_dd_refuses_bad_meshes():
    space = H1Space(beam_hex().refined(), 1)
    with pytest.raises(ValueError, match="no \\(gx, gy\\) grid"):
        SlabDecomposition(space, ("cpu",) * 3)
    with pytest.raises(ValueError, match="needs a device mesh"):
        SlabDecomposition(space, None)
    with pytest.raises(ValueError, match="CUDA card"):
        SlabDecomposition(space, [f"cuda:{torch.cuda.device_count()}"])
