"""Recovery on the port (``repro_torch.serve.recovery``,
``repro_torch.checkpoint``, ``repro_torch.distributed.elastic``) on the
CPU: the reference's ``tests/test_faults.py`` cases that need one device,
on the port's service (p=1, refine=0, ``max_batch`` 4, chunks of 2).

Every case holds a killed-and-restored run against the port's own
undisturbed run, BITWISE: same tickets, iteration counts and flags,
solutions and residual norms.  One case runs the reference's service
and recovery on the same stream and crash point, and holds the port to
its per-ticket iterations and flags, solutions (1e-10 of max |x|),
recovery counters, spans and checkpoint layout.

The scripted crashes come from ``tests/faultinject.py`` (the engine
points are duck-typed); the torn checkpoint write is this file's own,
since it patches the port's manager module."""

from __future__ import annotations

import contextlib
import glob
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.obs import SpanRecorder as RefSpanRecorder
from repro.serve import ElasticityService as RefElasticityService
from repro.serve import ServiceRecovery as RefServiceRecovery
from repro.serve import SolveRequest as RefSolveRequest
from repro.solvers.batched import BatchedGMGSolver as RefBatchedGMGSolver
import repro_torch.checkpoint.manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.elastic import (
    StepWatchdog,
    elastic_scenario_mesh,
    simulate_failures,
)
from repro_torch.distributed.sharding import device_put_scenario
from repro_torch.fem.mesh import beam_hex
from repro_torch.launch import serve_solve
from repro_torch.obs import SpanRecorder
from repro_torch.serve import ElasticityService, ServiceRecovery, SolveRequest
from repro_torch.solvers.batched import BatchedGMGSolver

from tests._hypothesis_compat import given, settings, st
from tests.faultinject import FaultInjector, SimulatedCrash, run_schedule

SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

MATS_A = {1: (50.0, 50.0), 2: (1.0, 1.0)}
MATS_B = {1: (80.0, 60.0), 2: (2.0, 1.0)}
MATS_C = {1: (9.0, 9.0), 2: (1.0, 3.0)}
ARRIVALS = [(0, 0), (0, 1), (0, 2), (1, 3), (2, 4), (4, 5)]


@pytest.fixture(scope="module")
def shared_solver():
    """One p=1/refine=0 solver seeded into every service these tests
    build, so a fresh service skips the build."""
    return BatchedGMGSolver(beam_hex(), 0, 1, maxiter=200, device="cpu")


def _req(i: int, request_cls=SolveRequest, refine: int = 0):
    return request_cls(
        p=1,
        refine=refine,
        materials=(MATS_A, MATS_B, MATS_C)[i % 3],
        traction=(0.0, 2e-3 * (i % 2), -1e-2 * (1.0 + 0.25 * i)),
        rel_tol=1e-8 if i % 2 else 1e-10,
        keep_solution=True,
    )


def _service(solver=None, **kw) -> ElasticityService:
    kw.setdefault("max_batch", 4)
    kw.setdefault("chunk_iters", 2)
    svc = ElasticityService(device="cpu", **kw)
    if solver is not None:
        svc._solvers[svc.group_key(_req(0))] = solver
    return svc


def _schedule(request_cls=SolveRequest, refine: int = 0):
    return [(s, _req(i, request_cls, refine)) for s, i in ARRIVALS]


def _by_ticket(reports):
    out = {r.ticket: r for r in reports}
    assert len(out) == len(reports), "duplicate tickets surfaced"
    return out


def assert_reports_identical(base, got):
    """Same tickets, iteration counts and flags, and bit-identical
    solutions and residual norms; padding rows never surface."""
    assert set(base) == set(got)
    for t in sorted(base):
        a, b = base[t], got[t]
        assert (a.iterations, a.converged, a.precision, a.fallback) == (
            b.iterations, b.converged, b.precision, b.fallback), t
        assert not a.born_converged and not b.born_converged
        assert a.final_rel_norm == b.final_rel_norm, t
        np.testing.assert_array_equal(a.x, b.x)


@contextlib.contextmanager
def torn_checkpoint_write(after_leaves: int):
    """Crash the next checkpoint of the port's manager mid-write:
    ``np.save`` dies after ``after_leaves`` leaf writes, leaving a
    manifest-less ``.tmp-`` staging dir."""
    orig = manager_mod.np.save
    n = 0

    def bomb(path, arr, *args, **kwargs):
        nonlocal n
        n += 1
        if n > after_leaves:
            raise SimulatedCrash(f"torn checkpoint write after {after_leaves} leaves")
        return orig(path, arr, *args, **kwargs)

    manager_mod.np.save = bomb
    try:
        yield
    finally:
        manager_mod.np.save = orig


# -- torn checkpoints -------------------------------------------------------
def test_torn_checkpoint_write_in_process(tmp_path):
    """A crash mid-write leaves a manifest-less staging dir;
    latest()/restore skip it and the next good save GCs it."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"a": np.arange(4.0), "b": np.ones(3)}, extra={"k": 1})
    with torn_checkpoint_write(after_leaves=1):
        with pytest.raises(SimulatedCrash):
            mgr.save(2, {"a": np.zeros(4), "b": np.ones(3)}, extra={"k": 2})
    assert glob.glob(str(tmp_path / "*.tmp-*")), "expected a torn staging dir"
    assert mgr.latest() == 1
    items, extra, step = mgr.restore_latest_items()
    assert step == 1 and extra == {"k": 1}
    np.testing.assert_array_equal(items["a"], np.arange(4.0))
    mgr.save(3, {"a": np.full(4, 3.0), "b": np.ones(3)}, extra={"k": 3})
    assert not glob.glob(str(tmp_path / "*.tmp-*")), "stale tmp not GCed"
    assert mgr.latest() == 3


def test_sigkill_mid_checkpoint_write_subprocess(tmp_path):
    """A real SIGKILL between two leaf writes: the parent finds the
    older checkpoint intact and the torn one skippable."""
    script = """
import os, signal, sys
import numpy as np
from repro_torch.checkpoint.manager import CheckpointManager

mgr = CheckpointManager(sys.argv[1], keep=3)
mgr.save(1, {"a": np.arange(4.0), "b": np.ones(3)}, extra={"k": 1})
orig, calls = np.save, [0]
def bomb(path, arr, *a, **kw):
    calls[0] += 1
    if calls[0] > 1:
        os.kill(os.getpid(), signal.SIGKILL)
    return orig(path, arr, *a, **kw)
np.save = bomb
mgr.save(2, {"a": np.zeros(4), "b": np.ones(3)}, extra={"k": 2})
"""
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path)],
        env={**os.environ, "PYTHONPATH": SRC_DIR}, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert glob.glob(str(tmp_path / "*.tmp-*")), "expected a torn staging dir"
    mgr = CheckpointManager(str(tmp_path), keep=3)
    assert mgr.latest() == 1
    items, _, step = mgr.restore_latest_items()
    assert step == 1
    np.testing.assert_array_equal(items["a"], np.arange(4.0))


# -- crash/restore differentials ---------------------------------------------
def _decisions(svc, after_step: int = 0) -> list:
    """The scheduler's decisions of the steps after ``after_step``, with
    what the policy saw and what the chunk consumed."""
    return [(d.step, d.bucket, d.chunk, d.live_slots, d.consumed, d.observation.live_iters,
             d.observation.history, tuple((r.ticket, r.slot) for r in d.refills))
            for d in svc.trace.decisions if d.step > after_step]


# (refine, chunk policy): the reference's p=1/refine=0 stream, whose rows
# all finish in their first chunk, and a refine=1 stream whose rows live
# across chunks, so the adaptive policy reads the iteration mirror the
# checkpoint carries.
STREAMS = {"refine0-fixed": (0, "fixed"), "refine1-adaptive": (1, "adaptive")}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("point", FaultInjector.POINTS)
def test_crash_restore_differential(tmp_path, shared_solver, point, stream):
    """Kill the engine at a scripted point at step 2; a fresh service
    restored from the last checkpoint and driven through the same
    arrival schedule drains bitwise the undisturbed run's reports, and
    its chunk policy makes the undisturbed run's decisions (the
    checkpoint carries the folded iteration mirror and retire history)."""
    refine, policy = STREAMS[stream]
    undisturbed = _service(shared_solver, chunk_policy=policy)
    base = _by_ticket(run_schedule(undisturbed, _schedule(refine=refine)))
    assert set(base) == set(range(len(ARRIVALS)))

    svc = _service(shared_solver, chunk_policy=policy)
    rec = ServiceRecovery(svc, str(tmp_path), every=1)
    FaultInjector(svc).arm(point, at_step=2)
    with pytest.raises(SimulatedCrash):
        run_schedule(svc, _schedule(refine=refine), rec)
    assert rec.manager.latest() == 1

    svc2 = _service(shared_solver, chunk_policy=policy)
    rec2 = ServiceRecovery(svc2, str(tmp_path), every=1)
    assert rec2.restore()
    assert svc2._step_index == 1
    got = _by_ticket(run_schedule(svc2, _schedule(refine=refine), rec2))
    assert_reports_identical(base, got)
    assert _decisions(svc2) == _decisions(undisturbed, after_step=1)
    assert svc2.stats["restores"] == 1
    assert svc2.stats["checkpoints_written"] == svc2._step_index - 1


@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
def test_checkpointing_changes_no_decision(tmp_path, policy):
    """A run that checkpoints every step (folding each pending consumed
    vector early) reports and schedules exactly as one that never
    checkpoints: the fold is not repeated by the next retire pass."""
    plain = _service(chunk_policy=policy)
    base = _by_ticket(run_schedule(plain, _schedule(refine=1)))
    svc = _service(chunk_policy=policy)
    rec = ServiceRecovery(svc, str(tmp_path), every=1, keep=1)
    assert_reports_identical(base, _by_ticket(run_schedule(svc, _schedule(refine=1), rec)))
    assert _decisions(svc) == _decisions(plain)
    assert dict(svc.stats) == {**dict(plain.stats), "checkpoints_written": svc._step_index}
    assert rec.manager.available_steps() == [svc._step_index]


def test_crash_during_checkpoint_then_resume(tmp_path, shared_solver):
    """Die mid-checkpoint (torn write) and restart: the torn checkpoint
    is skipped, the previous one restores, and the drained reports are
    still bitwise the undisturbed run's."""
    up_front = [(0, _req(i)) for i in range(len(ARRIVALS))]
    base = _by_ticket(run_schedule(_service(shared_solver), up_front))

    svc = _service(shared_solver)
    rec = ServiceRecovery(svc, str(tmp_path), every=1)
    for _, r in up_front:
        svc.submit(r)
    svc.step()
    rec.maybe_checkpoint()
    svc.step()
    with torn_checkpoint_write(after_leaves=3):
        with pytest.raises(SimulatedCrash):
            rec.checkpoint()
    assert rec.manager.latest() == 1  # the step-2 checkpoint is torn

    svc2 = _service(shared_solver)
    rec2 = ServiceRecovery(svc2, str(tmp_path))
    assert rec2.restore()
    assert svc2._step_index == 1
    svc2.run_until_idle()
    assert_reports_identical(base, _by_ticket(svc2.drain()))


def test_restore_preconditions(tmp_path, shared_solver):
    """restore() demands an empty service, reports absence honestly, and
    refuses a max_batch mismatch and ``every`` < 1 loudly."""
    svc = _service(shared_solver)
    rec = ServiceRecovery(svc, str(tmp_path))
    assert rec.restore() is False  # empty dir: nothing to restore
    svc.submit(_req(0))
    svc.step()
    rec.checkpoint()
    with pytest.raises(RuntimeError, match="empty service"):
        rec.restore()
    with pytest.raises(ValueError, match="max_batch"):
        ServiceRecovery(_service(shared_solver, max_batch=8), str(tmp_path)).restore()
    with pytest.raises(ValueError, match="every"):
        ServiceRecovery(svc, str(tmp_path), every=0)


# -- the random-schedule property ----------------------------------------------
def _random_schedule(seed: int):
    """The reference property test's draws: (arrivals, point, kill_at)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 7))
    steps = np.sort(rng.integers(0, 5, size=n))
    arrivals = [(int(s), _req(i)) for i, s in enumerate(steps)]
    point = FaultInjector.POINTS[int(rng.integers(0, 2))]
    return arrivals, point, int(rng.integers(1, 6))


def _crash_and_resume(solver, arrivals, point, kill_at, directory) -> bool | None:
    """Run the schedule undisturbed, then with a crash at ``point`` from
    step ``kill_at`` and a restart; hold the restarted run's reports
    bitwise to the undisturbed run's.  Returns what ``restore()`` gave
    (False: the kill struck before the first checkpoint, and the
    restart is a fresh service that takes every arrival from ticket 0),
    or None when the run ended before the kill point."""
    base = _by_ticket(run_schedule(_service(solver), arrivals))
    assert set(base) == set(range(len(arrivals)))
    svc = _service(solver)
    rec = ServiceRecovery(svc, directory, every=1)
    FaultInjector(svc).arm(point, at_step=kill_at)
    restored = None
    try:
        got = _by_ticket(run_schedule(svc, arrivals, rec))
    except SimulatedCrash:
        svc2 = _service(solver)
        rec2 = ServiceRecovery(svc2, directory, every=1)
        restored = rec2.restore()
        got = _by_ticket(run_schedule(svc2, arrivals, rec2))
    assert_reports_identical(base, got)
    return restored


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_property_random_schedule_crash_restore(seed, tmp_path_factory, shared_solver):
    """For a random arrival/kill schedule, restart-and-drain is bitwise
    the undisturbed run, whether the restart restores a checkpoint or
    (killed before the first one) starts fresh."""
    arrivals, point, kill_at = _random_schedule(seed)
    directory = str(tmp_path_factory.mktemp(f"recovery{seed}"))
    _crash_and_resume(shared_solver, arrivals, point, kill_at, directory)


def test_seed0_schedule_kills_before_the_first_checkpoint(tmp_path, shared_solver):
    """Seed 0 of the property draws a kill inside step 1, before any
    checkpoint: restore() returns False and the fresh restart still
    drains the undisturbed run's reports bitwise."""
    arrivals, point, kill_at = _random_schedule(0)
    assert ([s for s, _ in arrivals], point, kill_at) == ([0, 0, 1, 1, 2, 3], "mid-chunk", 1)
    assert _crash_and_resume(shared_solver, arrivals, point, kill_at, str(tmp_path)) is False


# -- against the reference ---------------------------------------------------------
def _span_keys(recorder) -> set:
    return {(s.name, s.args.get("step"), s.args.get("flights")) for s in recorder.spans}


def _layout(directory) -> dict:
    """Per checkpoint step: (leaf path, shape, dtype) of every leaf (the
    pickled host blob's length left out), and ``extra``."""
    out = {}
    for step in CheckpointManager(directory).available_steps():
        with open(os.path.join(directory, f"step_{step:09d}", "manifest.json")) as f:
            m = json.load(f)
        out[step] = ([(e["path"], None if e["path"] == "['host']" else e["shape"], e["dtype"])
                      for e in m["leaves"]], m["extra"])
    return out


def _run_crash_restore(service_cls, recovery_cls, recorder_cls, request_cls, solver, directory):
    """Crash mid-chunk at step 2, restore, drain: (reports by ticket,
    restored service, its recovery, crashed service's spans)."""
    def service():
        svc = service_cls(max_batch=4, chunk_iters=2, spans=recorder_cls(fence=False),
                          **({"device": "cpu"} if service_cls is ElasticityService else {}))
        svc._solvers[svc.group_key(_req(0, request_cls))] = solver
        return svc

    svc = service()
    FaultInjector(svc).arm("mid-chunk", at_step=2)
    with pytest.raises(SimulatedCrash):
        run_schedule(svc, _schedule(request_cls), recovery_cls(svc, directory, every=1))
    svc2 = service()
    rec2 = recovery_cls(svc2, directory, every=1)
    assert rec2.restore()
    return _by_ticket(run_schedule(svc2, _schedule(request_cls), rec2)), svc2, rec2, svc.spans


def test_crash_restore_matches_reference(tmp_path, shared_solver):
    """The reference's service and recovery on the same stream and crash
    point: the port gives its per-ticket iterations and flags, x within
    1e-10 of max |x|, summary() counters, span names with their
    step/flights arguments, and checkpoint layout.  The port refuses to
    restore the reference's checkpoint (its host blob names the
    reference package's classes)."""
    ref_solver = RefBatchedGMGSolver(ref_beam_hex(), 0, 1, maxiter=200)
    want, rsvc, rrec, rspans = _run_crash_restore(
        RefElasticityService, RefServiceRecovery, RefSpanRecorder, RefSolveRequest, ref_solver,
        str(tmp_path / "reference"))
    got, psvc, prec, pspans = _run_crash_restore(
        ElasticityService, ServiceRecovery, SpanRecorder, SolveRequest, shared_solver,
        str(tmp_path / "port"))
    assert set(got) == set(want) == set(range(len(ARRIVALS)))
    for t, w in want.items():
        g = got[t]
        assert (g.iterations, g.converged, g.precision, g.fallback, g.born_converged) == (
            w.iterations, w.converged, w.precision, w.fallback, w.born_converged), t
        wx = np.asarray(w.x)
        np.testing.assert_allclose(g.x, wx, rtol=0, atol=1e-10 * np.abs(wx).max())
    drop_dir = lambda s: {k: v for k, v in s.items() if k != "directory"}  # noqa: E731
    assert drop_dir(prec.summary()) == drop_dir(rrec.summary())
    assert dict(psvc.stats) == dict(rsvc.stats)
    assert _span_keys(pspans) == _span_keys(rspans)
    assert _span_keys(psvc.spans) == _span_keys(rsvc.spans)
    assert {k for k in _span_keys(psvc.spans) if k[0] in ("restore", "checkpoint_write")}
    assert _layout(str(tmp_path / "port")) == _layout(str(tmp_path / "reference"))
    with pytest.raises(ValueError, match="repro.serve"):
        ServiceRecovery(_service(shared_solver), str(tmp_path / "reference")).restore()


# -- watchdog and the elastic helpers -----------------------------------------------
def test_watchdog_fires_counter_and_span():
    """A step past the armed timeout increments watchdog_fires and emits
    a watchdog_fire span on the engine track (the first step of a fresh
    service builds its solver, which dwarfs the 1 ms timeout)."""
    svc = _service()
    svc.attach_spans(SpanRecorder())
    fired = []
    wd = svc.attach_watchdog(1e-3, on_timeout=fired.append)
    assert isinstance(wd, StepWatchdog) and svc.watchdog is wd
    svc.submit(_req(0))
    svc.run_until_idle()
    svc.drain()
    assert wd.timeouts >= 1 and wd.slowest > 1e-3
    assert fired and fired[0] > 1e-3
    assert svc.stats["watchdog_fires"] == wd.timeouts
    assert svc.spans.count("watchdog_fire") == wd.timeouts
    assert all(s.tid == 0 for s in svc.spans.by_name("watchdog_fire"))


def test_elastic_helpers_on_one_card():
    """The survivor mesh over virtual CPU devices; a card the host lacks
    raises; a host state goes onto the survivor mesh as row blocks."""
    mesh = elastic_scenario_mesh(["cpu"] * 2)
    assert mesh == (torch.device("cpu"),) * 2
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"the host has {n_cards} CUDA card"):
        elastic_scenario_mesh([f"cuda:{i}" for i in range(n_cards + 1)])
    tree = {"x": np.arange(8.0).reshape(4, 2), "k": 3}
    placed = device_put_scenario(tree, mesh)
    assert placed["k"] == 3 and [b.tolist() for b in placed["x"].blocks] == [
        [[0.0, 1.0], [2.0, 3.0]], [[4.0, 5.0], [6.0, 7.0]]]
    assert simulate_failures([0, 1, 2, 3], 3) == [0]
    with pytest.raises(ValueError):
        simulate_failures([0, 1], 2)


# -- the CLI: SIGKILL + --resume ---------------------------------------------------
def test_cli_kill_resume_bitwise(tmp_path):
    """serve_solve --continuous SIGKILLed mid-flight (--kill-after-steps)
    and restarted with --resume gives --report-out lines equal to an
    uninterrupted run's, the solutions' sha256 included."""
    common = [
        sys.executable, "-m", "repro_torch.launch.serve_solve", "--device", "cpu",
        "--continuous", "--n-requests", "6", "--max-batch", "4", "--p", "1",
        "--refine", "0", "--rel-tol", "1e-10", "--chunk-iters", "2",
    ]
    env = {**os.environ, "PYTHONPATH": SRC_DIR}

    def run(extra):
        return subprocess.run(common + extra, env=env, cwd=tmp_path, capture_output=True,
                              text=True, timeout=300)

    a = run(["--report-out", "a.jsonl"])
    assert a.returncode == 0, a.stderr
    b = run(["--checkpoint-dir", "ckpt", "--checkpoint-every", "1",
             "--kill-after-steps", "1", "--report-out", "b.jsonl"])
    assert b.returncode == -signal.SIGKILL, (b.returncode, b.stderr)
    assert not (tmp_path / "b.jsonl").exists()  # died mid-flight
    c = run(["--checkpoint-dir", "ckpt", "--resume", "--report-out", "c.jsonl"])
    assert c.returncode == 0, c.stderr
    assert "resumed from checkpoint step 1" in c.stdout
    assert "recovery: {'checkpoints_written'" in c.stdout

    def load(p):
        return {rec["ticket"]: rec
                for rec in map(json.loads, (tmp_path / p).read_text().splitlines())}

    base, got = load("a.jsonl"), load("c.jsonl")
    assert set(base) == set(got) == set(range(6))
    for t in base:
        assert base[t] == got[t], (t, base[t], got[t])
        assert base[t]["x_sha256"] is not None


def test_cli_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    """--resume over an empty directory serves a fresh workload, and
    --checkpoint-dir without --continuous is refused."""
    args = ["--device", "cpu", "--n-requests", "2", "--p", "1", "--refine", "0",
            "--checkpoint-dir", str(tmp_path / "none")]
    serve_solve.main(["--continuous", "--resume", *args])
    out = capsys.readouterr().out
    assert f"no usable checkpoint in {tmp_path / 'none'}; starting fresh" in out
    assert "2 scenarios" in out and "'checkpoints_written': 2" in out
    with pytest.raises(SystemExit):
        serve_solve.main(args)
    assert "--checkpoint-dir requires --continuous" in capsys.readouterr().err
