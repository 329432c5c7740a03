"""Scenario-axis sharding on the port, on the CPU: the batched solver and
the solve service split over 1, 2 and 4 virtual CPU devices (a mesh of
repeated ``"cpu"`` entries, ``repro_torch.distributed.sharding``) against
the unsharded port and against the reference's iteration counts on its
one device.

The reference's ``tests/test_sharded_batched.py`` case for case, where
its multi-device cases skip on one device and these run: identical
iteration counts, convergence and born-converged flags, solutions within
1e-12 of max |x|.  Then the layout check, the host copies a checkpoint
makes, and the elastic restores of ``tests/test_faults.py``: a
checkpoint restored onto fewer devices through the identity path
(bitwise), and a 3-row flight restored onto 2 devices through the
re-bucket branch (rows kept in place bitwise, moved rows within 1e-12).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.serve import ElasticityService as RefElasticityService
from repro.solvers.batched import BatchedGMGSolver as RefSolver
from repro.fem.mesh import beam_hex as ref_beam_hex
from repro_torch.distributed.sharding import (
    ScenarioBlocks,
    gather_scenario,
    scenario_layout_mismatches,
    scenario_mesh,
    tree_to,
)
from repro_torch.fem.mesh import beam_hex
from repro_torch.serve import ElasticityService, ServiceRecovery, SolveRequest
from repro_torch.solvers.batched import BatchedGMGSolver, bpcg_result
from repro_torch.solvers.gmg import hierarchy_spaces
from tests.faultinject import run_schedule

# (n_h_refine, p) per test p: p=1 runs the h-transfer ladder, p=2 the
# p-embedding one.
DISCRETIZATIONS = {1: (1, 1), 2: (0, 2)}
BUCKETS = (1, 2, 4, 8)
MAXITER = 150
NDEV = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small solves run no faster on more, and
    idle OpenMP threads spin on the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n):
    return None if n is None else scenario_mesh(n, device="cpu")


def scenarios(n: int):
    """The reference's deterministic mixed batch (row i depends on i
    alone); row 1 has a zero traction, so it is born converged."""
    mats, tr, tol = [], [], []
    for i in range(n):
        stiff = 50.0 + 7.0 * (i % 3)
        soft = 1.0 + 0.5 * (i % 2)
        mats.append({1: (stiff, 0.9 * stiff), 2: (soft, soft)})
        if i == 1:
            tr.append((0.0, 0.0, 0.0))
        else:
            tr.append((0.0, 2e-3 * (i % 2), -1e-2 * (1 + 0.2 * (i % 4))))
        tol.append(1e-9 if i % 3 == 0 else 1e-6)
    return mats, np.asarray(tr), np.asarray(tol)


_SOLVERS: dict = {}
_FULL: dict = {}
_REF_ITERS: dict = {}


def _solver(p: int, ndev) -> BatchedGMGSolver:
    """The port's solver on ``ndev`` virtual CPU devices (None: unsharded)
    with the reference's power-iteration start vectors."""
    if (p, ndev) not in _SOLVERS:
        refine, p_target = DISCRETIZATIONS[p]
        key = jax.random.PRNGKey(1234)
        sv = [np.array(jax.random.normal(key, (sp.nscalar, 3), dtype=np.float64))
              for sp in hierarchy_spaces(beam_hex(), refine, p_target)[1:]]
        _SOLVERS[p, ndev] = BatchedGMGSolver(
            beam_hex(), refine, p_target, maxiter=MAXITER, device="cpu",
            start_vectors=sv, mesh=cpu_mesh(ndev),
        )
    return _SOLVERS[p, ndev]


def _full(p: int, bucket: int):
    """The unsharded port's solve of the first ``bucket`` scenarios."""
    if (p, bucket) not in _FULL:
        _FULL[p, bucket] = _solver(p, None).solve(*scenarios(bucket))
    return _FULL[p, bucket]


def _ref_iters(p: int) -> np.ndarray:
    """The reference's per-row iterations of scenarios(8) on its one
    device (rows never couple: a bucket's rows are a prefix)."""
    if p not in _REF_ITERS:
        refine, p_target = DISCRETIZATIONS[p]
        res = RefSolver(ref_beam_hex(), refine, p_target, maxiter=MAXITER).solve(*scenarios(8))
        _REF_ITERS[p] = np.asarray(res.iterations)
    return _REF_ITERS[p]


def assert_results_match(res, ref, context: str):
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations.numpy(), err_msg=context)
    np.testing.assert_array_equal(res.converged.numpy(), ref.converged.numpy(), err_msg=context)
    scale = float(ref.x.abs().max()) or 1.0
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), atol=1e-12 * scale, rtol=0,
                               err_msg=context)
    for name in ("final_norm", "initial_norm"):
        np.testing.assert_allclose(getattr(res, name).numpy(), getattr(ref, name).numpy(),
                                   rtol=1e-8, atol=1e-300, err_msg=f"{context}: {name}")


# -- solver-level differentials ---------------------------------------------
@pytest.mark.parametrize("ndev", NDEV)
@pytest.mark.parametrize("p", [1, 2])
def test_sharded_full_solve_matches_single_device(p, ndev):
    """solve() on a 1/2/4-device mesh reproduces the unsharded result for
    every bucket, including buckets smaller than the mesh (device
    padding) and non-dividing ones, with the reference's iterations."""
    solver = _solver(p, ndev)
    for bucket in BUCKETS:
        res = solver.solve(*scenarios(bucket))
        assert res.x.shape[0] == bucket  # padding sliced off
        assert_results_match(res, _full(p, bucket), f"p={p} bucket={bucket} devices={ndev}")
        np.testing.assert_array_equal(res.iterations.numpy(), _ref_iters(p)[:bucket])
        if bucket >= 2:  # the zero-traction row is born converged
            assert int(res.iterations[1]) == 0 and float(res.initial_norm[1]) == 0.0


def _chunked_solve(solver: BatchedGMGSolver, mats, tr, tol, k: int):
    """prepare all rows, a reset chunk, then bounded chunks until no row
    is active, as the continuous engine drives the step program."""
    mats, tr, tol, s = solver.pad_scenarios(mats, tr, tol)
    n = len(mats)
    lam, mu = solver.pack_materials(mats)
    reset = np.ones((n,), dtype=bool)
    prep = solver.prepare(lam, mu, reset, solver.empty_prep(n))
    state, consumed = solver.run_chunk(
        tr, tol, reset, solver.empty_state(n), prep, k, do_reset=True
    )
    assert consumed.shape == (n,)
    guard = 0
    while bool(state.active.to("cpu").any()):
        state, _ = solver.run_chunk(tr, tol, np.zeros((n,), dtype=bool), state, prep, k)
        guard += 1
        assert guard < 500, "chunked solve did not drain"
    res = bpcg_result(state)
    return dataclasses.replace(
        res, **{f.name: getattr(res, f.name)[:s] for f in dataclasses.fields(res)}
    )


@pytest.mark.parametrize("ndev", NDEV)
@pytest.mark.parametrize("p", [1, 2])
def test_sharded_chunked_solve_matches_single_device(p, ndev):
    """prepare + run_chunk on a device mesh == the unsharded full solve:
    chunk boundaries and sharding are both invisible to the iteration."""
    res = _chunked_solve(_solver(p, ndev), *scenarios(4), k=3)
    assert_results_match(res, _full(p, 4), f"chunked p={p} devices={ndev}")
    np.testing.assert_array_equal(res.iterations.numpy(), _ref_iters(p)[:4])


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_state_and_prep_are_laid_out(ndev):
    """State rows and folded element fields really are split: one block
    of S/n rows per mesh device, which scenario_layout_mismatches accepts;
    a block on another device and an unsplit leaf are named."""
    solver = _solver(1, ndev)
    n = solver.pad_batch(ndev)
    mats, tr, tol = scenarios(n)
    lam, mu = solver.pack_materials(mats)
    reset = np.ones((n,), dtype=bool)
    prep = solver.prepare(lam, mu, reset, solver.empty_prep(n))
    state, consumed = solver.run_chunk(tr, tol, reset, solver.empty_state(n), prep, 2,
                                       do_reset=True)
    mesh = solver.mesh
    assert len(mesh) == ndev
    assert scenario_layout_mismatches((state, prep, consumed), mesh) == []
    for leaf in (state.x, state.r, prep["chol"], *prep["lam_w"], *prep["mu_w"]):
        assert isinstance(leaf, ScenarioBlocks) and leaf.devices == mesh
        assert {b.shape[0] for b in leaf.blocks} == {leaf.shape[0] // ndev}
    moved = ScenarioBlocks(state.x.blocks[:-1] + (state.x.blocks[-1].to("meta"),))
    bad = scenario_layout_mismatches(
        dataclasses.replace(state, x=moved, nom=state.nom.to("cpu")), mesh
    )
    assert len(bad) == 2 and bad[0].startswith(".x:") and bad[1].startswith(".nom:")


def _blocking(leaf) -> np.ndarray:
    """A leaf on the host through one blocking copy a block."""
    blocks = leaf.blocks if isinstance(leaf, ScenarioBlocks) else (leaf,)
    return torch.cat([b.cpu() for b in blocks]).numpy()


def test_sharded_host_copies_equal_blocking_copies():
    """What a checkpoint writes of a sharded state and prep
    (state_to_host, prep_to_host), and gather_scenario / tree_to onto the
    host, equal one blocking copy a block bitwise.  The card's case, with
    work still queued on the blocks, is in test_torch_cuda.py."""
    solver = _solver(1, 2)
    mats, tr, tol = scenarios(4)
    lam, mu = solver.pack_materials(mats)
    reset = np.ones((4,), dtype=bool)
    prep = solver.prepare(lam, mu, reset, solver.empty_prep(4))
    state, _ = solver.run_chunk(tr, tol, reset, solver.empty_state(4), prep, 2, do_reset=True)
    for f in dataclasses.fields(state):
        np.testing.assert_array_equal(solver.state_to_host(state)[f.name],
                                      _blocking(getattr(state, f.name)), err_msg=f.name)
    host = solver.prep_to_host(prep)
    np.testing.assert_array_equal(host["chol"], _blocking(prep["chol"]))
    np.testing.assert_array_equal(host["lam_w0"], _blocking(prep["lam_w"][0]))
    np.testing.assert_array_equal(gather_scenario(state.r, "cpu").numpy(), _blocking(state.r))
    np.testing.assert_array_equal(tree_to({"x": state.x}, "cpu")["x"].numpy(),
                                  _blocking(state.x))


# -- service-level differentials --------------------------------------------
def service_requests(n: int = 5):
    reqs = []
    for i in range(n):
        stiff = 50.0 + 6.0 * (i % 3)
        reqs.append(
            SolveRequest(
                p=1,
                refine=1,
                materials={1: (stiff, stiff), 2: (1.0 + 0.5 * (i % 2), 1.0)},
                traction=(0.0, 0.0, 0.0) if i == 1
                else (0.0, 1e-3 * (i % 2), -1e-2 * (1 + 0.3 * (i % 3))),
                rel_tol=1e-9 if i % 3 == 0 else 1e-5,
                keep_solution=(i % 2 == 0),
            )
        )
    return reqs


def assert_reports_match(reps, refs, context: str):
    assert len(reps) == len(refs)
    for i, (a, b) in enumerate(zip(reps, refs)):
        ctx = f"{context} request {i}"
        assert (a.iterations, a.converged, a.born_converged, a.batch_size, a.generation,
                a.ndof) == (b.iterations, b.converged, b.born_converged, b.batch_size,
                            b.generation, b.ndof), ctx
        np.testing.assert_allclose(a.final_rel_norm, b.final_rel_norm, rtol=1e-8,
                                   atol=1e-300, err_msg=ctx)
        assert (a.x is None) == (b.x is None), ctx
        if a.x is not None:
            scale = float(np.abs(b.x).max()) or 1.0
            np.testing.assert_allclose(a.x, b.x, atol=1e-12 * scale, rtol=0, err_msg=ctx)


_SERVICES: dict = {}


def _service(ndev, policy="fixed") -> ElasticityService:
    if (ndev, policy) not in _SERVICES:
        _SERVICES[ndev, policy] = ElasticityService(
            max_batch=4, chunk_iters=3, maxiter=MAXITER, device="cpu",
            mesh=cpu_mesh(ndev), chunk_policy=policy,
        )
    return _SERVICES[ndev, policy]


@pytest.mark.parametrize("ndev", [1, 2])
def test_sharded_service_generational_matches_single_device(ndev):
    """Generational batches on a sharded service give the unsharded
    reports: iterations, flags, norms, solutions, generation and batch
    bookkeeping (device padding is invisible)."""
    reqs = service_requests()
    refs = _service(None).solve(list(reqs))
    reps = _service(ndev).solve(list(reqs))
    assert_reports_match(reps, refs, f"generational devices={ndev}")
    assert [r.born_converged for r in reps] == [False, True, False, False, False]
    for r in reps:
        assert r.padded_rows >= r.batch_size and r.padded_rows % ndev == 0


@pytest.mark.parametrize("ndev", [1, 2])
def test_sharded_service_continuous_matches_single_device(ndev):
    """Continuous scheduling (retire/refill/re-bucket) on a sharded
    service gives the unsharded reports, with the same refill and
    prepare() counts."""
    reqs = service_requests()
    base_ref = dict(_service(None).stats)
    base = dict(_service(ndev).stats)
    refs = _service(None).solve_continuous(list(reqs))
    reps = _service(ndev).solve_continuous(list(reqs))
    assert_reports_match(reps, refs, f"continuous devices={ndev}")
    for k in ("refills", "prep_calls"):
        assert (_service(ndev).stats[k] - base[k]
                == _service(None).stats[k] - base_ref[k]), k


def test_shard_adaptive_policy_sees_the_mesh():
    """The shard-aware chunk policy observes two devices and rows on both
    of them; scheduling never changes the reports."""
    reqs = service_requests()
    svc = _service(2, "shard-adaptive")
    reps = svc.solve_continuous(list(reqs))
    assert_reports_match(reps, _service(None).solve_continuous(list(reqs)), "shard-adaptive")
    obs = [d.observation for d in svc.trace.decisions]
    assert obs and all(o.n_devices == 2 for o in obs)
    assert any(set(o.live_devices) == {0, 1} for o in obs)
    assert {r.device for d in svc.trace.decisions for r in d.refills} == {0, 1}


# -- padding accounting -----------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_bucket_for_rounds_to_device_multiple(n_shards):
    """bucket_for equals the reference's, device counts that are not
    powers of two included."""
    svc = ElasticityService(max_batch=8, device="cpu")
    ref = RefElasticityService(max_batch=8)
    svc.n_shards = ref.n_shards = n_shards
    assert [svc.bucket_for(n) for n in range(1, 10)] == [ref.bucket_for(n) for n in range(1, 10)]


def test_report_counts_device_padding_rows():
    """With a 2-device mesh, padded_rows grows to the reference's
    device-aligned bucket while batch_size counts only real requests."""
    svc = ElasticityService(max_batch=8, maxiter=MAXITER, device="cpu", mesh=cpu_mesh(2))
    ref = RefElasticityService(max_batch=8)
    ref.n_shards = 2
    for n in (1, 3):
        reps = svc.solve(service_requests(n))
        assert [(r.batch_size, r.padded_rows) for r in reps] == [(n, ref.bucket_for(n))] * n


# -- elastic restores ---------------------------------------------------------
MATS = ({1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (80.0, 60.0), 2: (2.0, 1.0)},
        {1: (9.0, 9.0), 2: (1.0, 3.0)})


def _req(i: int, rel_tol=None, refine: int = 0) -> SolveRequest:
    return SolveRequest(
        p=1, refine=refine, materials=MATS[i % 3],
        traction=(0.0, 2e-3 * (i % 2), -1e-2 * (1.0 + 0.25 * i)),
        rel_tol=(1e-8 if i % 2 else 1e-10) if rel_tol is None else rel_tol,
        keep_solution=True,
    )


def _restore_service(ndev, max_batch=8) -> ElasticityService:
    return ElasticityService(max_batch=max_batch, chunk_iters=2, maxiter=200, device="cpu",
                             mesh=cpu_mesh(ndev))


def _by_ticket(reports):
    return {r.ticket: r for r in reports}


@pytest.mark.parametrize("before, after", [(4, 2), (2, 1)])
def test_elastic_restore_identity_bitwise(tmp_path, before, after):
    """A flight checkpointed on more devices restores onto fewer through
    the identity path (the bucket divides the new mesh): every leaf lands
    split over the survivor mesh, and the reports equal the undisturbed
    run's bitwise."""
    arrivals = [(0, _req(i)) for i in range(6)]
    base = _by_ticket(run_schedule(_restore_service(before), arrivals))

    svc1 = _restore_service(before)
    rec1 = ServiceRecovery(svc1, str(tmp_path), every=1)
    for _, r in arrivals:
        svc1.submit(r)
    svc1.step()
    rec1.maybe_checkpoint()

    svc2 = _restore_service(after)
    rec2 = ServiceRecovery(svc2, str(tmp_path))
    assert rec2.restore()
    for fl in svc2._flights.values():
        assert fl.bucket % after == 0 and fl.pending_reset is None
        assert scenario_layout_mismatches((fl.state, fl.prep), svc2.mesh) == []
    got = _by_ticket(run_schedule(svc2, arrivals, rec2))
    assert set(got) == set(base)
    for t, a in base.items():
        b = got[t]
        assert (a.iterations, a.converged, a.final_rel_norm) == (
            b.iterations, b.converged, b.final_rel_norm), t
        np.testing.assert_array_equal(a.x, b.x)


def test_elastic_restore_rebucket_three_rows_onto_two(tmp_path):
    """A 3-row flight (``max_batch`` 3 on a 3-device mesh) checkpointed after its
    middle row retired restores onto 2 devices through the re-bucket
    branch: the live rows compact onto bucket 2, the row left in place
    resumes bitwise and the moved row within 1e-12 of the undisturbed
    run, with equal iterations and flags."""
    reqs = [_req(0, refine=1), _req(1, rel_tol=1e-1, refine=1), _req(2, refine=1)]
    arrivals = [(0, r) for r in reqs]
    base = _by_ticket(run_schedule(_restore_service(3, 3), arrivals))

    svc1 = _restore_service(3, 3)
    rec1 = ServiceRecovery(svc1, str(tmp_path), every=1)
    for r in reqs:
        svc1.submit(r)
    svc1.step()
    svc1.step()  # retires ticket 1 (loose tolerance) at its start
    rec1.maybe_checkpoint()
    (fl1,) = svc1._flights.values()
    assert fl1.bucket == 3 and fl1.live_rows() == [0, 2]

    svc2 = _restore_service(2, 3)
    rec2 = ServiceRecovery(svc2, str(tmp_path))
    assert rec2.restore()
    (fl2,) = svc2._flights.values()
    assert fl2.bucket == 2 and [s.ticket for s in fl2.slots] == [0, 2]
    assert svc2.stats["rebuckets"] == 1
    assert scenario_layout_mismatches((fl2.state, fl2.prep), svc2.mesh) == []
    got = _by_ticket(run_schedule(svc2, arrivals, rec2))
    assert set(got) == set(base)
    for t, a in base.items():
        b = got[t]
        assert (a.iterations, a.converged) == (b.iterations, b.converged), t
        if t == 2:
            np.testing.assert_allclose(b.x, a.x, atol=1e-12 * np.abs(a.x).max(), rtol=0)
            assert b.final_rel_norm == pytest.approx(a.final_rel_norm, rel=1e-8)
        else:
            np.testing.assert_array_equal(a.x, b.x)
            assert a.final_rel_norm == b.final_rel_norm
