"""Scenario-axis placement: what the solve service needs of it on one card.

The reference shards the scenario axis of every batched solver over a
1-D device mesh.  The port runs on one card: ``normalize_scenario_mesh``
accepts only the single-device spellings, and the row-to-device map is
the same host math as the reference's, so the shard-aware chunk policy
runs unchanged (every row on device 0).  Sharding over more than one
card is ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_scenario_mesh", "scenario_row_devices"]


def normalize_scenario_mesh(mesh) -> tuple[None, int]:
    """``(mesh, n_shards)`` from the ``mesh`` option of the service:
    ``None`` or ``1`` give ``(None, 1)``; anything else raises."""
    if mesh is None or (isinstance(mesh, int) and mesh == 1):
        return None, 1
    raise NotImplementedError(
        f"scenario sharding over {mesh!r} devices is not ported "
        f"(ROADMAP Queue 1 item 10); the port runs on one card"
    )


def scenario_row_devices(s: int, n_shards: int) -> np.ndarray:
    """Device index owning each of ``s`` scenario rows under axis-0
    scenario sharding: the axis splits into ``n_shards`` contiguous
    blocks of ``s // n_shards`` rows, so row ``r`` lives on device
    ``r // (s // n_shards)``.  Pure host math (the shard-aware chunk
    policy consumes it every step); ``s`` must divide the mesh."""
    if n_shards < 1:
        raise ValueError(f"scenario_row_devices: n_shards must be >= 1, got {n_shards}")
    if s % n_shards:
        raise ValueError(
            f"scenario_row_devices: {s} rows do not divide {n_shards} shards"
        )
    return np.arange(s) // max(s // n_shards, 1)
