"""Per-phase profile of a run, shared by the launch CLIs (``--profile``)."""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["print_profile"]


def print_profile(run, prefix: str, top: int = 8) -> None:
    """Run ``run()`` under torch.profiler and print, for each phase (a
    ``record_function`` range whose name starts with ``prefix``), its
    host time, the device time of the kernels and copies that ran inside
    it (their ratio is the device's busy share in that phase), and its
    top kernels by device time.  A phase ends in a synchronize, so every
    device event that a phase caused starts inside its host range."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()
    events = prof.events()
    phases = sorted(
        (e for e in events
         if e.name.startswith(prefix) and e.device_type == DeviceType.CPU),
        key=lambda e: e.time_range.start,
    )
    device = [
        e for e in events
        if e.device_type == DeviceType.CUDA and not e.name.startswith(prefix)
    ]
    for ph in phases:
        lo, hi = ph.time_range.start, ph.time_range.end
        per_kernel: dict[str, list] = {}
        for e in device:
            if lo <= e.time_range.start < hi:
                acc = per_kernel.setdefault(e.name, [0.0, 0])
                acc[0] += e.time_range.elapsed_us()
                acc[1] += 1
        busy = sum(us for us, _ in per_kernel.values())
        host = ph.time_range.elapsed_us()
        print(f"[profile] {ph.name}: host {host / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / host if host else 0:.1f}%)")
        ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
        for name, (us, n) in ranked[:top]:
            print(f"[profile]   {us / 1e3:9.3f} ms {100 * us / busy if busy else 0:5.1f}% "
                  f"x{n:<6d} {name[:100]}")
