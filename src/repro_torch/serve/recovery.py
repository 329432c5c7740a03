"""Fault-tolerant continuous serving: checkpoint/restore of in-flight
solver state.

A preempted :class:`~repro_torch.serve.elasticity_service.
ElasticityService` loses every in-flight solve; :class:`ServiceRecovery`
makes the engine restartable by snapshotting, at step boundaries (where
chunked resumption is exact, see :func:`repro_torch.solvers.batched.
bpcg_chunk`), everything the engine needs to resume:

* per flight: the resumable :class:`~repro_torch.solvers.batched.
  BpcgState` and prep (brought to the host bitwise through
  ``BatchedGMGSolver.state_to_host``/``prep_to_host``, the mixed
  policy's ``lam_w_solve``/``mu_w_solve`` twins included), the folded
  material/traction/tolerance rows, the prep-reuse digests and the
  scheduling mirrors (``row_iters``, retire history) the adaptive chunk
  policies feed on, so a restored engine makes the SAME scheduling
  decisions;
* the queue, ticket counter, fallback-ticket set, step index and any
  undrained completed reports.

Everything rides one :class:`repro_torch.checkpoint.manager.
CheckpointManager` checkpoint (atomic rename, manifest last, per-leaf
CRC), as a flat ``{name: array}`` dict plus one pickled host-metadata
blob, restored via ``restore_latest_items``: torn or corrupt checkpoints
are skipped newest-first.  The blob is read with an unpickler that
resolves only this package, numpy and the standard library.

Restore may land on another device count (elastic rescale).  A flight
whose bucket divides the new scenario mesh keeps its bucket and restores
every array bitwise, so the resumed service finishes every in-flight
request with the solutions and iteration counts of an uninterrupted run.
One whose bucket does not divide it is re-bucketed: its live rows move
onto the smallest device-aligned bucket (their state and prep bitwise,
through ``BatchedGMGSolver.take_rows``), and the filler rows, copies of
the first live row with zero right-hand sides, are marked for reset.

The hang detector lives on the service itself
(``ElasticityService.attach_watchdog``); its fires land in the same
metrics registry (``service_watchdog_fires_total``) and span stream as
the ``checkpoint_write``/``restore`` spans recorded here.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import sys

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.serve.elasticity_service import (
    ElasticityService,
    SolveReport,
    SolveRequest,
    _Flight,
    _Slot,
)

__all__ = ["ServiceRecovery"]

_FORMAT = 1


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_request(req: SolveRequest) -> SolveRequest:
    """A pickle-safe copy of a request: per-element material fields may
    arrive as torch tensors (on the card); the checkpoint stores host
    numpy."""
    m = req.materials
    if m is not None and not isinstance(m, dict):
        lam_e, mu_e = m
        return dataclasses.replace(req, materials=(_np(lam_e), _np(mu_e)))
    return req


def _host_report(rep: SolveReport) -> SolveReport:
    return dataclasses.replace(
        rep,
        request=_host_request(rep.request),
        x=None if rep.x is None else _np(rep.x),
    )


def _object_row(values) -> np.ndarray:
    """(n,) object array from a python list (digest bytes / 0 fillers)
    without numpy trying to deep-convert the elements."""
    out = np.zeros((len(values),), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


class _HostUnpickler(pickle.Unpickler):
    """Resolves classes of this package, numpy and the standard library
    only: a checkpoint that names anything else (the reference package's
    requests, say) raises ValueError instead of importing it."""

    def find_class(self, module: str, name: str):
        top = module.split(".")[0]
        if top in ("repro_torch", "numpy") or top in sys.stdlib_module_names:
            return super().find_class(module, name)
        raise ValueError(
            f"checkpoint host blob names {module}.{name}; only repro_torch, "
            f"numpy and the standard library are restored"
        )


class ServiceRecovery:
    """Periodic in-flight checkpoints + startup restore for one
    :class:`ElasticityService`.

    Usage (the ``serve_solve --checkpoint-dir/--resume`` loop)::

        recovery = ServiceRecovery(service, ckpt_dir, every=4)
        if resume:
            recovery.restore()          # False when no usable checkpoint
        ...
        while not service.idle():
            service.step()
            recovery.maybe_checkpoint()

    ``every`` is in engine steps; ``keep`` bounds disk use (forwarded to
    the :class:`CheckpointManager`).  Checkpointing never changes
    numerics: the only engine state it touches is the early fold of each
    flight's pending consumed vector, which the next retire pass would
    perform identically.
    """

    def __init__(
        self,
        service: ElasticityService,
        directory: str,
        *,
        every: int = 1,
        keep: int = 3,
    ):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")
        self.service = service
        self.manager = CheckpointManager(directory, keep=keep)
        self.every = every
        self.last_step: int | None = None  # step of the last local save

    # -- observability -------------------------------------------------------
    def summary(self) -> dict:
        """The ``recovery`` section of the CLI stats line."""
        svc = self.service
        return {
            "checkpoints_written": svc.stats["checkpoints_written"],
            "restores": svc.stats["restores"],
            "watchdog_fires": svc.stats["watchdog_fires"],
            "last_step": self.last_step,
            "directory": self.manager.directory,
        }

    # -- write ---------------------------------------------------------------
    def maybe_checkpoint(self) -> str | None:
        """Checkpoint when ``every`` steps have passed since the last
        local save (call once per ``step()``)."""
        step = self.service._step_index
        if self.last_step is not None and step - self.last_step < self.every:
            return None
        return self.checkpoint()

    def checkpoint(self) -> str:
        """Snapshot the full serving state at the current step boundary
        and commit it atomically.  Returns the checkpoint directory."""
        svc = self.service
        rec = svc.spans
        t0 = svc.clock() if rec is not None else 0.0
        arrays: dict[str, np.ndarray] = {}
        flights = []
        for i, (key, fl) in enumerate(svc._flights.items()):
            # Fold the last chunk's consumed vector now (waits for the
            # chunk); pending_consumed goes to None, so the next retire
            # pass does not fold it again.
            if fl.pending_consumed is not None:
                svc._finalize_chunk(fl, fl.pending_consumed.cpu().numpy())
            flights.append(
                {
                    "key": key,
                    "bucket": fl.bucket,
                    "chunks": fl.chunks,
                    "slots": [
                        None
                        if s is None
                        else (s.ticket, _host_request(s.request))
                        for s in fl.slots
                    ],
                    "retire_history": list(fl.retire_history),
                    "mat_digest": list(fl.mat_digest),
                    "prep_digest": list(fl.prep_digest),
                    "prep_valid": fl.prep_valid.tolist(),
                }
            )
            pre = f"flight{i}/"
            for name, arr in fl.solver.state_to_host(fl.state).items():
                arrays[pre + "state/" + name] = arr
            for name, arr in fl.solver.prep_to_host(fl.prep).items():
                arrays[pre + "prep/" + name] = arr
            arrays[pre + "lam"] = fl.lam
            arrays[pre + "mu"] = fl.mu
            arrays[pre + "tr"] = fl.tr
            arrays[pre + "tol"] = fl.tol
            arrays[pre + "row_iters"] = fl.row_iters
            arrays[pre + "prep_lam"] = fl.prep_lam
            arrays[pre + "prep_mu"] = fl.prep_mu
        blob = {
            "format": _FORMAT,
            "flights": flights,
            "queue": [(t, _host_request(r)) for t, r in svc._queue],
            "completed": {t: _host_report(r) for t, r in svc._completed.items()},
            "fallback_tickets": sorted(svc._fallback_tickets),
            "next_ticket": svc._next_ticket,
            "step_index": svc._step_index,
        }
        arrays["host"] = np.frombuffer(
            pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL), dtype=np.uint8
        )
        path = self.manager.save(
            svc._step_index,
            arrays,
            extra={
                "format": _FORMAT,
                "max_batch": svc.max_batch,
                "devices": svc.n_shards,
                "n_flights": len(flights),
                "n_queued": len(svc._queue),
            },
        )
        self.last_step = svc._step_index
        svc._inc_engine("checkpoints_written")
        if rec is not None:
            rec.emit(
                "checkpoint_write",
                cat="recovery",
                tid=0,
                start=t0,
                end=svc.clock(),
                step=svc._step_index,
                flights=len(flights),
                leaves=len(arrays),
            )
        return path

    # -- read ----------------------------------------------------------------
    def restore(self, step: int | None = None) -> bool:
        """Restore the newest verifiable checkpoint (or ``step``) into
        the (empty) service.  Returns False when none exists; raises on
        a config mismatch the engine cannot absorb (``max_batch``)."""
        svc = self.service
        if svc._flights or svc._queue or svc._completed or svc._next_ticket:
            raise RuntimeError(
                "ServiceRecovery.restore() needs an empty service "
                "(restore before the first submit/step)"
            )
        if step is None:
            got = self.manager.restore_latest_items()
            if got is None:
                return False
            items, extra, step = got
        else:
            items, extra = self.manager.restore_items(step)
        if extra.get("format") != _FORMAT:
            raise ValueError(
                f"checkpoint format {extra.get('format')!r} != {_FORMAT}"
            )
        if extra.get("max_batch") != svc.max_batch:
            raise ValueError(
                f"checkpoint max_batch {extra.get('max_batch')} != "
                f"service max_batch {svc.max_batch}"
            )
        rec = svc.spans
        t0 = svc.clock() if rec is not None else 0.0
        blob = _HostUnpickler(io.BytesIO(items["host"].tobytes())).load()
        now = svc.clock()
        for i, fb in enumerate(blob["flights"]):
            self._restore_flight(i, fb, items, now)
        svc._queue = [(t, r) for t, r in blob["queue"]]
        svc._t_submit = {t: now for t, _ in svc._queue}
        svc._completed = dict(blob["completed"])
        svc._fallback_tickets = set(blob["fallback_tickets"])
        svc._next_ticket = blob["next_ticket"]
        svc._step_index = blob["step_index"]
        self.last_step = blob["step_index"]
        svc._inc_engine("restores")
        if rec is not None:
            rec.emit(
                "restore",
                cat="recovery",
                tid=0,
                start=t0,
                end=svc.clock(),
                step=int(step),
                flights=len(blob["flights"]),
                from_devices=extra.get("devices"),
                to_devices=svc.n_shards,
            )
        return True

    def _restore_flight(self, i: int, fb: dict, items: dict, now: float) -> None:
        svc = self.service
        key = fb["key"]
        slots = fb["slots"]
        live = [r for r, s in enumerate(slots) if s is not None]
        # Any live slot's request rebuilds (or cache-hits) the solver.
        solver, hit, t_setup = svc._solver_for(key, slots[live[0]][1])
        fl = _Flight(key, solver, hit, t_setup, tid_base=svc._flight_tid())
        if svc.spans is not None:
            svc.spans.thread_name(fl.tid_base, f"flight p={key[0]} refine={key[1]}")

        pre = f"flight{i}/"
        part = lambda sub: {  # noqa: E731
            k[len(pre + sub):]: v for k, v in items.items() if k.startswith(pre + sub)
        }
        lam, mu = items[pre + "lam"], items[pre + "mu"]
        tr, tol = items[pre + "tr"], items[pre + "tol"]
        row_iters = items[pre + "row_iters"].astype(np.int64)
        prep_lam, prep_mu = items[pre + "prep_lam"], items[pre + "prep_mu"]
        mat_digest = _object_row(fb["mat_digest"])
        prep_digest = _object_row(fb["prep_digest"])
        prep_valid = np.asarray(fb["prep_valid"], dtype=bool)
        if fb["bucket"] % svc.n_shards == 0:
            # Identity layout: every row restores in place, bitwise, with
            # the bucket (and so the shapes) of the uninterrupted run.
            fl.state = solver.state_from_host(part("state/"))
            fl.prep = solver.prep_from_host(part("prep/"))
            fl.bucket = fb["bucket"]
            fl.slots = [
                None if s is None else _Slot(s[0], s[1], now, t_submit=now)
                for s in slots
            ]
            fl.pending_reset = None
        else:
            # Elastic re-bucket: the live rows compact onto the smallest
            # device-aligned bucket of the new mesh; the filler rows
            # (copies of the first live row) are marked for reset, so the
            # next launch turns them into born-converged padding.
            n_live = len(live)
            bucket = svc.bucket_for(max(n_live, 1))
            rows = live + [live[0]] * (bucket - n_live)
            fl.state, fl.prep = solver.take_rows(
                solver.state_from_host(part("state/"), place=False),
                solver.prep_from_host(part("prep/"), place=False),
                rows,
            )
            idx = np.asarray(rows)
            fl.bucket = bucket
            fl.slots = [
                _Slot(slots[r][0], slots[r][1], now, t_submit=now) for r in live
            ] + [None] * (bucket - n_live)
            lam, mu, tr, tol = lam[idx], mu[idx], tr[idx], tol[idx]
            row_iters = row_iters[idx]
            prep_lam, prep_mu = prep_lam[idx], prep_mu[idx]
            mat_digest, prep_digest = mat_digest[idx], prep_digest[idx]
            prep_valid = prep_valid[idx]
            tr[n_live:] = 0.0  # filler rows: zero RHS -> born converged
            tol[n_live:] = 1e-6
            row_iters[n_live:] = 0
            fl.pending_reset = np.arange(bucket) >= n_live
            svc._inc("rebuckets", key)
        fl.lam, fl.mu, fl.tr, fl.tol = lam, mu, tr, tol
        fl.row_iters = row_iters
        fl.mat_digest, fl.prep_digest = mat_digest, prep_digest
        fl.prep_lam, fl.prep_mu = prep_lam, prep_mu
        fl.prep_valid = prep_valid
        fl.chunks = fb["chunks"]
        fl.retire_history.extend(fb["retire_history"])
        svc._flights[key] = fl
