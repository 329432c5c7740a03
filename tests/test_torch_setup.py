"""Port vs reference: the numpy setup layer and the E<->L / transfer maps.

Tables, ids, masks, load vectors and 1-D transfer matrices must equal the
reference's arrays; the gather/scatter and prolong/restrict actions must
agree with the reference's to rtol 1e-14 in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import basis as ref_basis
from repro.core import flops as ref_flops
from repro.core import geometry as ref_geometry
from repro.fem import mesh as ref_mesh
from repro.fem import transfer as ref_transfer
from repro.fem.space import H1Space as RefSpace
from repro_torch import convert
from repro_torch.core import basis, flops, geometry
from repro_torch.core.precision import PRECISION_POLICIES, resolve_precision
from repro_torch.fem import mesh, transfer
from repro_torch.fem.space import H1Space

LINEAR_MAP = np.array([[1.0, 0.2, 0.1], [0.05, 1.0, 0.3], [0.1, 0.0, 1.0]])


def _meshes(kind):
    """(reference mesh, port mesh) pairs: the beam and a sheared box."""
    if kind == "beam":
        r = ref_mesh.beam_hex().refined()
    else:
        r = ref_mesh.HexMesh(3, 2, 2, (1.5, 1.0, 2.0), linear_map=LINEAR_MAP)
    return r, convert.hex_mesh(r)


@pytest.mark.parametrize("p", range(1, 9))
def test_basis_tables_equal(p):
    a, b = ref_basis.basis_tables(p), basis.basis_tables(p)
    for name in ("nodes", "qpts", "qwts", "B", "G"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert (b.d1d, b.q1d) == (a.d1d, a.q1d)
    assert flops.default_q1d(p) == ref_flops.default_q1d(p)
    assert flops.paop_flops_per_elem(p) == ref_flops.paop_flops_per_elem(p)


@pytest.mark.parametrize("kind", ["beam", "sheared"])
def test_mesh_and_geometry_equal(kind):
    r, m = _meshes(kind)
    assert m.shape == r.shape and m.lengths == r.lengths
    np.testing.assert_array_equal(m.attributes(), r.attributes())
    np.testing.assert_array_equal(m.jacobian(), r.jacobian())
    np.testing.assert_array_equal(m.refined(2).attributes(), r.refined(2).attributes())
    ga = ref_geometry.quadrature_geometry(r, ref_basis.basis_tables(3))
    gb = geometry.quadrature_geometry(m, basis.basis_tables(3))
    np.testing.assert_array_equal(gb.w_detj, ga.w_detj)
    np.testing.assert_array_equal(gb.jinv, ga.jinv)
    assert gb.detj == ga.detj
    mats = {1: (3.0, 2.0), 2: (1.5, 0.5)}
    for fa, fb in zip(
        ref_geometry.material_fields(r, mats), geometry.material_fields(m, mats)
    ):
        np.testing.assert_array_equal(fb, fa)


def test_material_checks_match_reference():
    attrs = np.array([1, 2, 2])
    for bad in ({1: (1.0, 1.0)}, {1: (1.0, 1.0), 2: (0.0, 1.0)}):
        with pytest.raises(ValueError) as ea:
            ref_geometry.check_material_dict(bad, attrs)
        with pytest.raises(ValueError) as eb:
            geometry.check_material_dict(bad, attrs)
        assert str(ea.value) == str(eb.value)
    with pytest.raises(ValueError, match="lam_e"):
        geometry.check_material_fields(np.ones(2), np.ones(3), 3)
    lam, mu = geometry.check_material_fields([1, 2, 3], [1, 1, 1], 3)
    assert lam.dtype == np.float64 and mu.shape == (3,)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("kind", ["beam", "sheared"])
def test_space_arrays_equal(p, kind):
    r, m = _meshes(kind)
    a, b = RefSpace(r, p), H1Space(m, p)
    np.testing.assert_array_equal(b.gather_ids, a.gather_ids)
    assert (b.nscalar, b.ndof, b.node_grid) == (a.nscalar, a.ndof, a.node_grid)
    for faces in (("x0",), ("x0", "y1", "z0")):
        np.testing.assert_array_equal(b.essential_mask(faces), a.essential_mask(faces))
    np.testing.assert_array_equal(
        b.traction_rhs("x1", (0.0, 0.0, -1e-2)), a.traction_rhs("x1", (0.0, 0.0, -1e-2))
    )
    np.testing.assert_array_equal(
        b.traction_rhs("z1", (0.3, -0.2, 1.0)), a.traction_rhs("z1", (0.3, -0.2, 1.0))
    )


@pytest.mark.parametrize("p", [1, 2, 3])
def test_incidence_table_covers_every_entry_once(p):
    sp = H1Space(mesh.beam_hex().refined(), p)
    table = sp.incidence
    pad = sp.nelem * sp.d1d ** 3
    used = table[table != pad]
    assert table.shape[1] == 8  # interior nodes of a refined beam
    np.testing.assert_array_equal(np.sort(used), np.arange(pad))
    ids = sp.gather_ids.reshape(-1)
    rows, _ = np.nonzero(table != pad)
    np.testing.assert_array_equal(ids[used], rows)
    # slots of one node are in increasing element order
    masked = np.where(table == pad, -1, table)
    assert (np.diff(masked, axis=1)[masked[:, 1:] >= 0] > 0).all()


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("kind", ["beam", "sheared"])
def test_gather_scatter_agree(p, kind):
    r, m = _meshes(kind)
    a, b = RefSpace(r, p), H1Space(m, p)
    rng = np.random.default_rng(p)
    u = rng.standard_normal((a.nscalar, 3))
    ye = rng.standard_normal((a.nelem, 3, a.d1d, a.d1d, a.d1d))
    ue_b = b.to_evec(torch.from_numpy(u))
    np.testing.assert_array_equal(ue_b.numpy(), np.asarray(a.to_evec(jnp.asarray(u))))
    assert ue_b.is_contiguous()
    ref = np.asarray(a.scatter_add(jnp.asarray(ye)))
    got = b.scatter_add(torch.from_numpy(ye)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14 * np.abs(ref).max())
    # E -> L -> E round trip: G^T G scales each node by its multiplicity.
    back = b.scatter_add(b.to_evec(torch.from_numpy(u))).numpy()
    np.testing.assert_allclose(back, u * a.dof_multiplicity[:, None], rtol=1e-15)


@pytest.mark.parametrize("n_el,pc,pf", [(3, 1, 2), (2, 2, 4), (4, 1, 3)])
def test_transfer_matrices_equal(n_el, pc, pf):
    np.testing.assert_array_equal(
        transfer.p_transfer_1d(n_el, pc, pf), ref_transfer.p_transfer_1d(n_el, pc, pf)
    )
    np.testing.assert_array_equal(
        transfer.h_transfer_1d(n_el, pc), ref_transfer.h_transfer_1d(n_el, pc)
    )


@pytest.mark.parametrize("step", ["h", "p"])
def test_prolong_restrict_agree(step):
    r, m = _meshes("beam")
    if step == "h":
        ca, fa = RefSpace(r, 1), RefSpace(r.refined(), 1)
        cb, fb = H1Space(m, 1), H1Space(m.refined(), 1)
    else:
        ca, fa = RefSpace(r, 2), RefSpace(r, 4)
        cb, fb = H1Space(m, 2), H1Space(m, 4)
    ta = ref_transfer.make_transfer(ca, fa, dtype=jnp.float64)
    tb = transfer.make_transfer(cb, fb, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    uc = rng.standard_normal((ca.nscalar, 3))
    rf = rng.standard_normal((fa.nscalar, 3))
    for got, ref in (
        (tb.prolong(torch.from_numpy(uc)), ta.prolong(jnp.asarray(uc))),
        (tb.restrict(torch.from_numpy(rf)), ta.restrict(jnp.asarray(rf))),
    ):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=1e-14, atol=1e-14 * np.abs(ref).max()
        )


def test_convert_operator_data_and_start_vectors():
    tb = basis.basis_tables(2)
    lam = np.ones((3, 4, 4, 4))
    data = convert.operator_data(
        lam, 2 * lam, np.eye(3), tb.B, tb.G, device="cpu", dtype=torch.float32
    )
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in data.values())
    assert float(data["mu_w"].sum()) == 2 * lam.size
    with pytest.raises(ValueError, match="Q1D"):
        convert.operator_data(
            np.ones((3, 5, 5, 5)), lam, np.eye(3), tb.B, tb.G,
            device="cpu", dtype=torch.float64,
        )
    sv = convert.start_vectors([np.ones((4, 3))], device="cpu", dtype=torch.float64)
    assert sv[0].shape == (4, 3) and sv[0].dtype == torch.float64


def test_precision_policies():
    assert set(PRECISION_POLICIES) == {"f64", "f32", "mixed", "mixed-bf16"}
    assert resolve_precision(None).name == "f64"
    assert resolve_precision(None, torch.float32).name == "f32"
    mixed = resolve_precision("mixed")
    assert (mixed.solve_dtype, mixed.precond_dtype) == (torch.float64, torch.float32)
    assert not mixed.uniform and PRECISION_POLICIES["f32"].uniform
    bf16 = resolve_precision("mixed-bf16")
    assert (bf16.solve_dtype, bf16.precond_dtype, bf16.coarse_dtype) == (
        torch.float64, torch.bfloat16, torch.float32)
    assert bf16.reduced and not bf16.uniform
    assert resolve_precision("mixed-bf16", torch.float64) is bf16
    with pytest.raises(ValueError, match="unknown precision"):
        resolve_precision("f16")
    with pytest.raises(ValueError, match="solves in"):
        resolve_precision("f32", torch.float64)
