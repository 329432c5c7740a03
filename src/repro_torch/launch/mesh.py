"""Meshes of torch devices for the LM side (the reference's
``repro.launch.mesh``).

Axis roles (see :mod:`repro_torch.distributed.sharding`):

* ``pod`` -- data parallelism across pods; the pipeline's stage axis;
* ``data`` -- data parallelism and FSDP within a pod;
* ``model`` -- tensor and expert parallelism.

:func:`make_local_mesh` builds a (data, model)
:class:`~repro_torch.distributed.sharding.LMMesh` over the host's cards
or over the devices given, repeats allowed: ``make_local_mesh(2,
devices=("cuda:0",) * 4)`` is a (2, 2) mesh of four virtual devices on
one card, the counterpart of the reference's forced host devices.

:func:`make_production_mesh` is the dry-run's mesh: 16 x 16 = 256 devices
over (data, model), or 2 x 16 x 16 = 512 with ``pod`` first, by default on
the meta device (shapes only; the chip host has one card, so a mesh of
real cards at this size is not built).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import LMMesh

__all__ = ["MESH_AXES", "make_local_mesh", "make_production_mesh", "axis_type_kwargs"]

MESH_AXES = {
    False: ("data", "model"),
    True: ("pod", "data", "model"),
}


def axis_type_kwargs(n: int) -> dict:
    """The reference's ``axis_types=(Auto,) * n`` for ``jax.make_mesh``:
    torch meshes have no axis types, so always ``{}`` (kept for the
    reference's call sites)."""
    return {}


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> LMMesh:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")`` with ``multi_pod``: every entry ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device(device))
    return LMMesh(arr, MESH_AXES[multi_pod])


def _host_cards() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("the host has no CUDA card; pass devices=('cpu',) * n for a mesh "
                           "of virtual CPU devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_local_mesh(model_parallel: int | None = None, devices=None) -> LMMesh:
    """A (data, model) mesh over ``devices`` (default: the host's cards),
    the model axis ``model_parallel`` wide, halved until it divides the
    device count (the reference's fallback)."""
    devices = list(devices) if devices is not None else _host_cards()
    n = len(devices)
    mp = model_parallel or 1
    while n % mp:
        mp //= 2
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return LMMesh(arr.reshape(n // mp, mp), MESH_AXES[False])
