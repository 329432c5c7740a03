"""The port's solve service on the paths one request stream does not
reach, against the reference on the CPU: the solver LRU with a flight in
progress, the f32 stagnation fallback, intake rejections, the
``serve_solve`` CLI; and, within the port, the batched solver's row moves
(``take_rows``, ``copy_prep_rows``) and the default device."""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve_solve as ref_cli
from repro.serve import elasticity_service as ref_es
from repro_torch.fem.mesh import beam_hex
from repro_torch.serve import elasticity_service as es
from repro_torch.solvers.batched import BatchedGMGSolver, BpcgState
from tests.test_torch_service import (  # noqa: F401 (patched is a fixture)
    MATS_A,
    MATS_B,
    assert_reports_match,
    field,
    patched,
    ref_start_solver,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def lru_run(m, **kw):
    """cache_size 1, chunks of 1: a tight p=1/refine=1 request is in
    flight when a p=2/refine=0 request arrives; the new key's solver must
    evict nothing in flight."""
    svc = m.ElasticityService(max_batch=2, cache_size=1, chunk_iters=1, **kw)
    svc.submit(m.SolveRequest(p=1, refine=1, materials=MATS_A, rel_tol=1e-12,
                              keep_solution=True))
    svc.step()
    in_flight = svc.group_key(m.SolveRequest(p=1, refine=1)) in svc._flights
    svc.submit(m.SolveRequest(p=2, refine=0, materials=MATS_B, rel_tol=1e-8,
                              keep_solution=True))
    svc.run_until_idle()
    again = svc.solve_continuous([m.SolveRequest(p=2, refine=0, rel_tol=1e-6,
                                                 keep_solution=True)])
    return svc.drain() + again, svc, in_flight


def test_lru_spares_the_in_flight_solver_like_the_reference(patched):
    want, ref, _ = lru_run(ref_es)
    got, svc, in_flight = lru_run(es, device="cpu")
    assert in_flight
    assert_reports_match(got, want)
    assert dict(svc.stats) == dict(ref.stats)
    assert list(svc._solvers) == list(ref._solvers)
    assert svc.stats["cache_misses"] == 3 and not got[2].cache_hit


def fallback_reqs(m):
    # refine 1: at refine 0 the V-cycle is the exact coarse solve and f32
    # iteration counts are rounding noise.
    return [m.SolveRequest(p=1, refine=1, rel_tol=1e-4, precision="f32", keep_solution=True),
            m.SolveRequest(p=1, refine=1, rel_tol=1e-13, precision="f32", keep_solution=True)]


def test_f32_stagnation_falls_back_to_f64_like_the_reference(patched, monkeypatch):
    """A tolerance below the f32 floor stalls; the continuous engine
    re-queues the ticket onto f64 and reports it with fallback=True, the
    generational path merges the solver's own f64 re-solve."""
    ref = ref_es.ElasticityService(max_batch=2)
    svc = es.ElasticityService(max_batch=2, device="cpu")
    want, got = ref.solve_continuous(fallback_reqs(ref_es)), svc.solve_continuous(
        fallback_reqs(es))
    # x and norms of an f32 row agree to f32 rounding (1e-4, as in
    # tests/test_torch_batched.py), the f64 re-solve to 1e-10.
    assert_reports_match(got[:1], want[:1], rtol=1e-4)
    assert_reports_match(got[1:], want[1:])
    assert [(r.precision, r.fallback) for r in got] == [("f32", False), ("f64", True)]
    assert all(r.converged and r.final_rel_norm <= r.request.rel_tol for r in got)
    assert svc.stats["precision_fallbacks"] == 1
    assert dict(svc.stats) == dict(ref.stats)
    gen_ref = ref_es.ElasticityService(max_batch=2, precision="f32").solve(fallback_reqs(ref_es))
    # The reference's f64 twin draws its start vectors at f64: so does
    # the port's, here.
    def twin(self):
        if self._f64_twin is None:
            self._f64_twin = ref_start_solver(
                self.coarse_mesh, self.n_h_refine, self.p_target,
                precision=es.resolve_precision("f64"), device=self.device,
                maxiter=self.maxiter)
        return self._f64_twin

    monkeypatch.setattr(BatchedGMGSolver, "_f64_fallback_solver", twin)
    gen = es.ElasticityService(max_batch=2, precision="f32", device="cpu").solve(
        fallback_reqs(es))
    assert_reports_match(gen[:1], gen_ref[:1], rtol=1e-4)
    assert_reports_match(gen[1:], gen_ref[1:])
    assert [r.fallback for r in gen] == [False, True]


BAD_REQUESTS = {
    "missing attribute": dict(materials={1: (50.0, 50.0)}),
    "non-positive": dict(materials={1: (50.0, 50.0), 2: (0.0, 1.0)}),
    "not a pair": dict(materials={1: (50.0, 50.0), 2: 3.0}),
    "field shape": dict(materials=(np.ones(7), np.ones(7))),
    "field value": dict(materials=(np.r_[np.ones(63), -1.0], np.ones(64))),
    "wrong type": dict(materials=3.5),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_submit_rejects_like_the_reference(case):
    ref = ref_es.ElasticityService()
    svc = es.ElasticityService(device="cpu")
    kw = dict(p=1, refine=1, **BAD_REQUESTS[case])
    with pytest.raises((ValueError, TypeError)) as want:
        ref.submit(ref_es.SolveRequest(**kw))
    with pytest.raises(type(want.value)) as got:
        svc.submit(es.SolveRequest(**kw))
    assert str(got.value) == str(want.value)
    assert svc.idle() and svc._next_ticket == 0


@pytest.mark.parametrize("kw", [
    {"max_batch": 0}, {"cache_size": 0}, {"chunk_iters": 0},
    {"chunk_policy": "adaptive", "min_chunk": 9, "max_chunk": 4},
    {"chunk_policy": "fixed", "max_chunk": 2},
], ids=lambda kw: ",".join(kw))
def test_constructor_rejects_like_the_reference(kw):
    with pytest.raises(ValueError) as want:
        ref_es.ElasticityService(**kw)
    with pytest.raises(ValueError) as got:
        es.ElasticityService(device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_left_out_parts_raise_and_idle_paths():
    svc = es.ElasticityService(device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        svc.attach_watchdog(1.0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        es.ElasticityService(device="cpu", mesh=2)
    # precision names fail at intake (the port has no bfloat16 policy yet)
    with pytest.raises(ValueError, match="unknown precision policy 'f16'"):
        svc.submit(es.SolveRequest(precision="f16"))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        svc.submit(es.SolveRequest(precision="mixed-bf16"))
    assert svc.step() == 0 and svc.drain() == [] and svc.solve([]) == []
    assert svc.latency_summary() == {}
    assert [svc.bucket_for(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        es.ElasticityService()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_solve",
                          "--n-requests", "1", "--p", "1", "--refine", "0"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def _states_equal(a: BpcgState, b: BpcgState, rows_a, rows_b) -> bool:
    return all(torch.equal(getattr(a, f.name)[rows_a], getattr(b, f.name)[rows_b])
               for f in dataclasses.fields(BpcgState))


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_take_rows_and_copy_prep_rows_are_bitwise(precision):
    """Rows kept by take_rows resume bitwise; copy_prep_rows gathers every
    source before it writes, so a swap swaps, and leaves its input
    alone."""
    solver = ref_start_solver(beam_hex(), 1, 1, precision=es.resolve_precision(precision),
                              device="cpu")
    mats = [MATS_A, field(2), MATS_B, field(3)]
    trs = np.array([[0, 0, -1e-2], [0, 1e-3, -2e-2], [0, 0, -5e-3], [0, 2e-3, -1e-2]])
    tols = np.array([1e-10, 1e-8, 1e-10, 1e-9])
    lam, mu = solver.pack_materials(mats)
    ones = np.ones(4, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(4))
    state, _ = solver.run_chunk(trs, tols, ones, solver.empty_state(4), prep, 3, do_reset=True)
    rows = [2, 0, 0]
    kept, kprep = solver.take_rows(state, prep, rows)
    assert _states_equal(kept, state, slice(None), rows)
    full, k = state, kept
    while bool(full.active.any()):
        full, _ = solver.run_chunk(trs, tols, ~ones, full, prep, 4)
    while bool(k.active.any()):
        k, _ = solver.run_chunk(trs[rows], tols[rows], np.zeros(3, bool), k, kprep, 4)
    assert _states_equal(k, full, slice(None), rows)

    swapped = solver.copy_prep_rows(prep, [0, 1], [1, 0])
    for key in ("lam_w", "mu_w", "dinv", "lmax"):
        for old, new in zip(prep[key], swapped[key]):
            o, n = old.reshape(4, -1), new.reshape(4, -1)
            assert torch.equal(n[[1, 0, 2, 3]], o)
    assert torch.equal(swapped["chol"][[1, 0, 2, 3]], prep["chol"])
    assert ("lam_w_solve" in prep) == (precision == "mixed")
    if precision == "mixed":
        assert torch.equal(swapped["lam_w_solve"].reshape(4, -1)[[1, 0, 2, 3]],
                           prep["lam_w_solve"].reshape(4, -1))
    assert not torch.equal(swapped["chol"], prep["chol"])  # input unchanged


def _iterations(text: str) -> list[int]:
    """The iters column of serve_solve's report table."""
    return [int(m.group(1)) for m in re.finditer(r"^\s*\d+ p\S+\s+\S+\s+\d+\s+(\d+)\s", text, re.M)]


def test_serve_solve_cli_matches_reference(capsys, monkeypatch):
    args = ["--continuous", "--n-requests", "5", "--p", "1", "--refine", "0"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_solve",
                          "--device", "cpu", *args],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    monkeypatch.setattr(sys, "argv", ["serve_solve", *args])
    ref_cli.main()
    want = capsys.readouterr().out
    assert _iterations(out.stdout) == _iterations(want) and len(_iterations(want)) == 5
    for line in ("service stats: ", "scheduler[fixed]: ", "latency: p50="):
        assert line in out.stdout
    stats = lambda t: re.search(r"service stats: (.*)", t).group(1)  # noqa: E731
    assert stats(out.stdout) == stats(want)
