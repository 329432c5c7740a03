"""Failure handling for the serving loop: the step watchdog, the
serving-side remesh and a device-loss test hook.

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
* :func:`simulate_failures` — deterministic device-loss test hook.
* :class:`StepWatchdog` — straggler/hang detection: a monitor thread
  that fires a callback when a step exceeds ``timeout``.  The solve
  service wires it onto ``step()`` via
  ``ElasticityService.attach_watchdog``.

The reference's training-side ``elastic_remesh`` (a (data, model)
device mesh) waits for the LM half of multi-device support, ROADMAP
Queue 1 item 10b.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from repro_torch.distributed.sharding import scenario_mesh

__all__ = ["elastic_scenario_mesh", "StepWatchdog", "simulate_failures"]


def elastic_scenario_mesh(devices=None):
    """The scenario mesh over the alive devices (all cards of the host by
    default), a tuple of ``torch.device`` as the service's ``mesh`` option
    takes it.  A device the host lacks raises."""
    return scenario_mesh(devices=devices)


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
