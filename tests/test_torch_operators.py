"""Port's ElasticityOperator vs the reference's, on the CPU in float64.

``apply``, ``diagonal`` and the constrained view agree with the reference
``paop`` operator at p in {1, 2, 4}, with attribute-dict and per-element
materials, on the beam and on a sheared box, to rtol 1e-12.  Both port
levels run: ``paop`` (plain PyTorch) and ``paop_cuda`` (whose wrapper
takes the plain version for CPU tensors)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operators import ElasticityOperator as RefOperator
from repro.fem.mesh import HexMesh as RefMesh
from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.fem.space import H1Space as RefSpace
from repro_torch import convert
from repro_torch.core.operators import ElasticityOperator
from repro_torch.fem.space import H1Space
from repro_torch.kernels.pa_elasticity import ops

LINEAR_MAP = np.array([[1.0, 0.2, 0.1], [0.05, 1.0, 0.3], [0.1, 0.0, 1.0]])
RTOL = 1e-12


def _ref_mesh(kind):
    if kind == "beam":
        return ref_beam_hex().refined()
    return RefMesh(3, 2, 2, (1.5, 1.0, 2.0), linear_map=LINEAR_MAP)


def _materials(kind, nelem):
    if kind == "dict":
        return {1: (50.0, 50.0), 2: (1.0, 1.0)}
    rng = np.random.default_rng(nelem)
    return (rng.uniform(0.5, 3.0, nelem), rng.uniform(0.5, 3.0, nelem))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max()
    )


def _mats(mesh_kind, mat):
    rm = _ref_mesh(mesh_kind)
    if mesh_kind == "sheared" and mat == "dict":
        return rm, {1: (2.0, 1.5)}  # the sheared box has one attribute
    return rm, _materials(mat, rm.nelem)


@functools.lru_cache(maxsize=None)
def _reference(p, mesh_kind, mat):
    """The reference operator's outputs on one random L-vector."""
    rm, mats = _mats(mesh_kind, mat)
    ref = RefOperator(RefSpace(rm, p), assembly="paop", materials=mats)
    x = np.random.default_rng(p).standard_normal((ref.space.nscalar, 3))
    rcop = ref.constrained()
    out = jax.jit(lambda v: (ref.apply(v), ref.diagonal(), rcop(v), rcop.diagonal()))(
        jnp.asarray(x)
    )
    return x, [np.asarray(o) for o in out], np.asarray(ref.ess_mask), ref.memory_bytes()


@pytest.mark.parametrize("assembly", ["paop", "paop_cuda"])
@pytest.mark.parametrize("mat", ["dict", "per_element"])
@pytest.mark.parametrize("mesh_kind", ["beam", "sheared"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_operator_matches_reference(p, mesh_kind, mat, assembly):
    rm, mats = _mats(mesh_kind, mat)
    x, refs, ess_mask, mem = _reference(p, mesh_kind, mat)
    op = ElasticityOperator(
        H1Space(convert.hex_mesh(rm), p), assembly=assembly, materials=mats,
        device="cpu",
    )
    xt = torch.from_numpy(x)
    before = ops.counts["pa_elasticity"].plain_calls
    cop = op.constrained()
    for got, ref in zip((op.apply(xt), op.diagonal(), cop(xt), cop.diagonal()), refs):
        _close(got, ref)
    np.testing.assert_array_equal(op.ess_mask.numpy(), ess_mask)
    assert op.memory_bytes() == mem
    calls = ops.counts["pa_elasticity"].plain_calls - before
    assert calls == (2 if assembly == "paop_cuda" else 0)


def test_operator_f32_matches_reference():
    rm = ref_beam_hex().refined()
    ref = RefOperator(RefSpace(rm, 2), assembly="paop", dtype=jnp.float32)
    op = ElasticityOperator(
        H1Space(convert.hex_mesh(rm), 2), dtype=torch.float32, device="cpu"
    )
    x = np.random.default_rng(3).standard_normal((ref.space.nscalar, 3)).astype(np.float32)
    y, r = op.apply(torch.from_numpy(x)), np.asarray(ref.apply(jnp.asarray(x)))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), r, rtol=2e-4, atol=2e-5 * np.abs(r).max())


def test_operator_rejects_bad_inputs():
    sp = H1Space(convert.hex_mesh(ref_beam_hex()), 1)
    with pytest.raises(ValueError, match="unknown assembly"):
        ElasticityOperator(sp, assembly="paop_pallas", device="cpu")
    with pytest.raises(ValueError, match="scenario batches"):
        ElasticityOperator(sp, materials=(np.ones((2, 8)), np.ones((2, 8))), device="cpu")
    with pytest.raises(TypeError, match="materials must be"):
        ElasticityOperator(sp, materials=3.0, device="cpu")
    with pytest.raises(ValueError, match="unknown attributes"):
        ElasticityOperator(sp, materials={1: (1.0, 1.0)}, device="cpu")


def test_operator_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    sp = H1Space(convert.hex_mesh(ref_beam_hex()), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticityOperator(sp)
