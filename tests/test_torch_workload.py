"""The port's copy of the batched service's request mix
(``repro_torch.launch.workload``) against the reference's
``repro.launch.serve_solve`` helpers: the same arrays, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.launch.serve_solve import make_material_field as ref_field
from repro.launch.serve_solve import make_workload as ref_workload
from repro_torch.fem.mesh import beam_hex
from repro_torch.launch.workload import make_material_field, make_workload


@pytest.mark.parametrize("i", [0, 5])
@pytest.mark.parametrize("kind", ["graded", "checkerboard", "lognormal", "lognormal:7"])
def test_material_field_matches_reference(kind, i):
    lam, mu = make_material_field(kind, beam_hex(), 1, i)
    ref_lam, ref_mu = ref_field(kind, ref_beam_hex(), 1, i)
    assert lam.dtype == mu.dtype == np.float64
    np.testing.assert_array_equal(lam, ref_lam)
    np.testing.assert_array_equal(mu, ref_mu)


@pytest.mark.parametrize("field", [None, "lognormal:3"])
def test_workload_matches_reference(field):
    mats, trs, tols = make_workload(6, 1, 1e-6, field)
    reqs = ref_workload(6, [2], 1, 1e-6, field)
    assert trs.shape == (6, 3) and tols.shape == (6,)
    for m, t, tol, req in zip(mats, trs, tols, reqs):
        assert tuple(t) == tuple(req.traction) and tol == req.rel_tol
        if field is None:
            assert m == req.materials
        else:
            np.testing.assert_array_equal(m[0], req.materials[0])
            np.testing.assert_array_equal(m[1], req.materials[1])


def test_unknown_material_field_raises():
    with pytest.raises(ValueError, match="unknown material field"):
        make_material_field("marble", beam_hex(), 0, 0)
