"""The port's solve service (``repro_torch.serve.elasticity_service``)
against the reference's on the CPU, on one request stream through the
generational path and the continuous path under the fixed and adaptive
chunk policies.

The stream (p=1, refine=1, ``max_batch`` 4, chunks of 3) mixes attribute
dicts and per-element fields, holds a zero-traction request (born
converged) and repeats two materials (prep-row copies), and drains from
bucket 4 to smaller buckets (re-bucketing).  The port's solvers get the
reference's power-iteration start vectors (the service module's
``BatchedGMGSolver`` is patched), so iteration counts match; the service
clock is injected, so spans, latency histograms and registry snapshots
are equal, not only the per-ticket reports."""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.obs.spans import SpanRecorder as RefSpanRecorder
from repro.serve import elasticity_service as ref_es
from repro_torch.fem.mesh import beam_hex
from repro_torch.obs.spans import SpanRecorder
from repro_torch.serve import elasticity_service as es
from repro_torch.solvers.batched import BatchedGMGSolver
from repro_torch.solvers.gmg import hierarchy_spaces

MATS_A = {1: (50.0, 50.0), 2: (1.0, 1.0)}
MATS_B = {1: (10.0, 5.0), 2: (2.0, 2.0)}
MATS_C = {1: (10.0, 8.0), 2: (2.0, 1.5)}
X_RTOL = 1e-10
REPORT_FIELDS = ("iterations", "converged", "born_converged", "batch_size",
                 "padded_rows", "generation", "precision", "fallback", "ticket",
                 "ndof", "cache_hit", "key")


def ref_start_solver(cmesh, refine, p, *, precision, **kw):
    """The port's solver with the reference's power-iteration start
    vectors (``jax.random.normal(PRNGKey(1234), ...)`` per smoothed level,
    at the policy's V-cycle dtype): what the tests patch into the
    service."""
    dt = np.float64 if precision.precond_dtype == torch.float64 else np.float32
    key = jax.random.PRNGKey(1234)
    sv = [np.array(jax.random.normal(key, (sp.nscalar, 3), dtype=dt))
          for sp in hierarchy_spaces(cmesh, refine, p)[1:]]
    return BatchedGMGSolver(cmesh, refine, p, precision=precision, start_vectors=sv, **kw)


@pytest.fixture
def patched(monkeypatch):
    monkeypatch.setattr(es, "BatchedGMGSolver", ref_start_solver)


def field(seed, refine=1):
    rng = np.random.default_rng(seed)
    ne = beam_hex().refined(refine).nelem
    return rng.lognormal(0.0, 0.5, ne), rng.lognormal(0.0, 0.5, ne)


F1 = field(1)
# (materials, traction, rel_tol): dict, field, zero traction, a repeat of
# request 0's materials, a repeat of request 1's field, another dict.
STREAM = [
    (MATS_A, (0.0, 0.0, -1e-2), 1e-8),
    (F1, (0.0, 1e-3, -2e-2), 1e-6),
    (MATS_B, (0.0, 0.0, 0.0), 1e-6),
    (MATS_A, (0.0, 0.0, -5e-3), 1e-10),
    (F1, (0.0, 2e-3, -1e-2), 1e-8),
    (MATS_C, (0.0, 0.0, -1e-2), 1e-6),
]
MODES = {"generational": None, "fixed": "fixed", "adaptive": "adaptive"}


def counting_clock():
    """A deterministic service clock: 0.25 s a call."""
    c = itertools.count()
    return lambda: 0.25 * next(c)


def requests(m, stream=STREAM, p=1, refine=1, **kw):
    return [m.SolveRequest(p=p, refine=refine, materials=mats, traction=tr,
                           rel_tol=tol, keep_solution=True, **kw)
            for mats, tr, tol in stream]


def run_mode(m, recorder_cls, mode, **kw):
    """One service of module ``m`` over the stream; returns (reports,
    service)."""
    svc = m.ElasticityService(max_batch=4, chunk_iters=3, chunk_policy=MODES[mode],
                              clock=counting_clock(), spans=recorder_cls(clock=counting_clock()),
                              **kw)
    reqs = requests(m)
    reports = svc.solve(reqs) if mode == "generational" else svc.solve_continuous(reqs)
    return reports, svc


@pytest.fixture(scope="module")
def reference_runs():
    return {mode: run_mode(ref_es, RefSpanRecorder, mode) for mode in MODES}


def decisions(svc):
    return [(d.step, d.bucket, d.chunk, d.live_slots, d.consumed, d.wasted,
             tuple((r.ticket, r.slot, r.device) for r in d.refills),
             d.observation.live_iters, d.observation.history)
            for d in svc.trace.decisions]


def assert_reports_match(got, want, rtol=X_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in REPORT_FIELDS:
            assert getattr(g, name) == getattr(w, name), (w.ticket, name)
        np.testing.assert_allclose(g.final_rel_norm, w.final_rel_norm, rtol=rtol)
        wx = np.asarray(w.x)
        assert isinstance(g.x, np.ndarray) and g.x.dtype == wx.dtype
        np.testing.assert_allclose(g.x, wx, rtol=rtol, atol=rtol * np.abs(wx).max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_matches_reference(patched, reference_runs, mode):
    want, ref = reference_runs[mode]
    got, svc = run_mode(es, SpanRecorder, mode, device="cpu")
    assert_reports_match(got, want)
    assert all(r.converged for r in got)
    assert [r.born_converged for r in got] == [False, False, True, False, False, False]
    assert dict(svc.stats) == dict(ref.stats)
    assert decisions(svc) == decisions(ref)
    assert svc.trace.summary() == ref.trace.summary()
    assert svc.registry.snapshot() == ref.registry.snapshot()
    assert svc.registry.to_prometheus_text() == ref.registry.to_prometheus_text()
    assert svc.latency_summary() == ref.latency_summary()
    assert svc.spans.to_events() == ref.spans.to_events()
    if mode != "generational":
        # the stream exercises both row moves of the continuous engine
        assert svc.stats["prep_row_copies"] > 0 and svc.stats["rebuckets"] > 0
        assert svc.trace.replay(svc.chunk_policy) == svc.trace.chunks()
        assert svc.idle() and svc.spans.open_count == 0


def test_continuous_equals_generational_within_the_port(patched):
    """Scheduling never changes numerics: same iterations and flags, x to
    1e-10 of max |x| (bucket shapes differ between the paths)."""
    gen, _ = run_mode(es, SpanRecorder, "generational", device="cpu")
    for mode in ("fixed", "adaptive"):
        cont, _ = run_mode(es, SpanRecorder, mode, device="cpu")
        for g, c in zip(gen, cont):
            assert (c.iterations, c.converged) == (g.iterations, g.converged)
            np.testing.assert_allclose(c.x, g.x, rtol=X_RTOL, atol=X_RTOL * np.abs(g.x).max())


def test_fencing_spans_keep_the_lifecycle_identity(patched):
    """With a fencing recorder each ticket's queue_wait + compute +
    overhead equals its submit-to-retire wall, on the real clock."""
    rec = SpanRecorder(fence=True)
    svc = es.ElasticityService(max_batch=4, chunk_iters=3, spans=rec, device="cpu")
    svc.solve_continuous(requests(es))
    solves = rec.by_name("solve")
    waits = {s.args["ticket"]: s for s in rec.by_name("queue_wait")}
    assert len(solves) == len(STREAM) and rec.count("chunk_device") == svc.stats["chunks"]
    for s in solves:
        a = s.args
        wall = s.end - waits[a["ticket"]].start
        assert a["queue_wait"] + a["compute"] + a["overhead"] == pytest.approx(wall, abs=1e-9)
        assert 0.0 < a["compute"] <= s.end - s.start
