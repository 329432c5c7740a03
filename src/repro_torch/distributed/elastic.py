"""Failure handling for the serving and training loops: the step
watchdog, the serving- and training-side remeshes, the reshard of a train
state and a device-loss test hook.

The recovery model is checkpoint-based: on any fault the job restarts
from the last complete checkpoint, possibly on a different device count.
For the continuous solve service that restart path is
:class:`repro_torch.serve.recovery.ServiceRecovery`, which restores
in-flight :class:`~repro_torch.solvers.batched.BpcgState` rows onto the
scenario mesh the survivor process builds here.

* :func:`elastic_scenario_mesh` — the serving-side remesh: a scenario
  mesh over the alive devices.  Scenarios never couple, so every device
  count is a valid mesh and a rescale is a row re-layout
  (``BatchedGMGSolver.take_rows``; a host or differently placed state
  goes onto a mesh through
  :func:`~repro_torch.distributed.sharding.device_put_scenario`).
* :func:`elastic_remesh` — the training-side remesh: the largest valid
  (data, model) :class:`~repro_torch.distributed.sharding.LMMesh` over
  the alive devices, keeping the model axis's size when the device count
  allows (the TP degree is architecture-bound; the DP degree is the
  elastic dimension).
* :func:`reshard_state` — a restored or differently laid out train state
  onto a mesh by its specs (:func:`~repro_torch.distributed.sharding.place`):
  full tensors on any device, or ``Sharded`` leaves of another mesh.
* :func:`simulate_failures` — deterministic device-loss test hook.
* :class:`StepWatchdog` — straggler/hang detection: a monitor thread
  that fires a callback when a step exceeds ``timeout``.  The solve
  service wires it onto ``step()`` via
  ``ElasticityService.attach_watchdog``.

A train state restarts on a new mesh from a checkpoint, which holds the
gathered state (``launch/train.py``): ``elastic_remesh`` over the
survivors, then ``reshard_state`` of the restored tensors.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed.sharding import LMMesh, place, scenario_mesh

__all__ = [
    "elastic_scenario_mesh",
    "elastic_remesh",
    "reshard_state",
    "StepWatchdog",
    "simulate_failures",
]


def elastic_scenario_mesh(devices=None):
    """The scenario mesh over the alive devices (all cards of the host by
    default), a tuple of ``torch.device`` as the service's ``mesh`` option
    takes it.  A device the host lacks raises."""
    return scenario_mesh(devices=devices)


def elastic_remesh(devices=None, *, model_parallel: int = 16,
                   axis_names=("data", "model")) -> LMMesh:
    """Largest (data, model) mesh over the alive devices (default: the
    host's cards).

    Keeps the model axis at ``model_parallel`` if the device count
    allows, else falls back to the largest power-of-two divisor — the
    params must still fit per-device, so shrinking TP is the last
    resort.  Drops stragglers beyond the largest usable rectangle."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = list(devices)
    n = len(devices)
    mp = model_parallel
    while mp > 1 and n // mp == 0:
        mp //= 2
    dp = n // mp
    if dp == 0:
        raise RuntimeError(f"not enough devices ({n}) for any mesh")
    arr = np.empty(dp * mp, dtype=object)
    arr[:] = devices[: dp * mp]
    return LMMesh(arr.reshape(dp, mp), axis_names)


def reshard_state(state, pspecs, mesh: LMMesh):
    """Place a (possibly host-resident, possibly differently sharded)
    state onto ``mesh`` by ``pspecs`` (a parallel tree of specs, e.g.
    ``state_pspecs(state, mesh)``).  Blocks are copies: the state given is
    left as it was."""
    return place(state, pspecs, mesh)


def simulate_failures(devices, n_failed: int):
    """Drop the last ``n_failed`` devices (test hook for elastic logic)."""
    if n_failed >= len(devices):
        raise ValueError("cannot fail every device")
    return devices[: len(devices) - n_failed]


class StepWatchdog:
    """Detects hung/straggling steps.

    Usage::

        wd = StepWatchdog(timeout_s=300, on_timeout=escalate)
        for batch in work:
            with wd.step():
                service.step()
    """

    def __init__(self, timeout_s: float, on_timeout: Callable[[float], None] | None = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.timeouts = 0
        self.slowest = 0.0

    class _StepCtx:
        def __init__(self, wd: "StepWatchdog"):
            self.wd = wd
            self._fired = threading.Event()
            self._done = threading.Event()

        def __enter__(self):
            self.t0 = time.perf_counter()

            def monitor():
                if not self._done.wait(self.wd.timeout_s):
                    self._fired.set()
                    self.wd.timeouts += 1
                    if self.wd.on_timeout:
                        self.wd.on_timeout(time.perf_counter() - self.t0)

            self._thread = threading.Thread(target=monitor, daemon=True)
            self._thread.start()
            return self

        def __exit__(self, *exc):
            self._done.set()
            self._thread.join(timeout=1.0)
            self.wd.slowest = max(self.wd.slowest, time.perf_counter() - self.t0)
            return False

    def step(self) -> "_StepCtx":
        return self._StepCtx(self)
