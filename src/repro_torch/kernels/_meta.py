"""The kernels' meta paths' report of their work.

A hand-written kernel called on a meta tensor (a stand-in that holds a
shape and a dtype, nothing else) returns an empty result and passes its
own analytic work, FLOPs and bytes, to :func:`charge`.  Whoever wants that
work (a cost model counting a trace) adds a callable to :data:`LISTENERS`
for as long as it counts; with none, :func:`charge` does nothing."""

from __future__ import annotations

from typing import Callable

__all__ = ["LISTENERS", "charge"]

LISTENERS: list[Callable[[float, float], None]] = []


def charge(flops: float, bytes: float) -> None:
    """Pass a kernel's analytic ``flops`` and ``bytes`` of one call to
    every listener."""
    for listen in LISTENERS:
        listen(flops, bytes)
