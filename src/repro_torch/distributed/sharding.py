"""Scenario-axis sharding of the batched solver over a list of devices.

The batched elasticity solve (:mod:`repro_torch.solvers.batched`) carries
a leading scenario axis S with no cross-scenario coupling: per-row inner
products, per-row smoother coefficients, per-row coarse factors.  A
scenario mesh is a tuple of ``torch.device``; every (S, ...) state and
prep tensor, and every folded (S * nelem, ...) element tensor, is split
along axis 0 into one contiguous row block per mesh device
(:class:`ScenarioBlocks`), and each device runs the single-device program
on its own rows; so the operators, the coarse probe and the Cholesky
solves take no mesh (the reference's ``shard_mesh`` options have no
counterpart).  The only traffic between devices is the (S,)-vector
convergence logic, gathered onto the first device and read by the host
once.

A device may repeat: ``("cpu",) * 4`` or ``("cuda:0",) * 4`` is four
virtual devices on one physical device.  That is what the reference's
forced host devices (``--xla_force_host_platform_device_count``) are,
so ``force_host_device_count`` has no counterpart here.  A mesh never
names more cards than the host has, and an int never repeats a card.
The reference's ``pin_scenario``, a constraint inside a compiled
program, has no counterpart either: placement is
:func:`device_put_scenario` on both sides of a program.

The row-to-device map (:func:`scenario_row_devices`) is host math shared
with the shard-aware chunk policy.  The LM side's FSDP/TP rules
(``param_pspecs``, ``state_pspecs``, ``batch_pspec``,
``decode_state_pspecs``, ``act_pspec``) are ROADMAP Queue 1 item 10b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = [
    "ScenarioBlocks",
    "scenario_mesh",
    "normalize_scenario_mesh",
    "device_put_scenario",
    "gather_scenario",
    "tree_to",
    "shard_of",
    "join_shards",
    "scenario_row_devices",
    "scenario_layout_mismatches",
]

Mesh = tuple[torch.device, ...]


def _card_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _mesh_device(d) -> torch.device:
    """``d`` as a mesh entry: a CPU device, or a CUDA card with its index
    that the host has."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"scenario mesh: unsupported device {dev}")
    dev = torch.device("cuda", 0 if dev.index is None else dev.index)
    n = _card_count()
    if dev.index >= n:
        raise ValueError(f"scenario mesh names {dev} but the host has {n} CUDA card(s)")
    return dev


def scenario_mesh(n_devices: int | None = None, devices=None, *, device=None) -> Mesh:
    """A 1-D scenario mesh: a tuple of ``torch.device``.

    With ``devices`` the mesh is that sequence, repeats allowed (virtual
    devices).  Otherwise ``n_devices`` takes the first n cards of the host
    (all of them when None), or n virtual CPU devices when ``device`` is
    the CPU; more cards than the host has raises."""
    if devices is None:
        if n_devices is not None and n_devices < 1:
            raise ValueError(f"scenario_mesh needs n_devices >= 1, got {n_devices}")
        if torch.device("cuda" if device is None else device).type == "cpu":
            return (torch.device("cpu"),) * (n_devices or 1)
        n_cards = _card_count()
        n = n_devices or max(n_cards, 1)
        if n > n_cards:
            raise ValueError(
                f"a scenario mesh of {n} CUDA card(s) but the host has {n_cards}"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = tuple(_mesh_device(d) for d in devices)
    if not mesh:
        raise ValueError("scenario_mesh needs at least one device")
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"scenario mesh mixes device types: {mesh}")
    return mesh


def normalize_scenario_mesh(mesh, device=None) -> tuple[Mesh | None, int]:
    """``(mesh, n_shards)`` from the ``mesh`` option every scenario-sharded
    constructor accepts: None (single-device), an int (the first n cards,
    or n virtual CPU devices when ``device`` is the CPU), or a sequence of
    devices.  A ``device`` of another type than a sequence's raises."""
    if mesh is None:
        return None, 1
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        mesh = scenario_mesh(int(mesh), device=device)
    else:
        mesh = scenario_mesh(devices=mesh)
        if device is not None and torch.device(device).type != mesh[0].type:
            raise ValueError(f"device {device} does not match the scenario mesh {mesh}")
    return mesh, len(mesh)


def _copy(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: queued on the stream when ``dev`` is a card, and a
    blocking copy to the host, whose reader may run at once (a
    non-blocking copy to the host lands in a pinned buffer later)."""
    return x.to(dev, non_blocking=dev.type == "cuda")


class ScenarioBlocks:
    """An (S, ...) tensor split along axis 0 into contiguous row blocks,
    block k on mesh device k.  ``to(device)`` gathers it into one tensor;
    an int index reads one row from the block that holds it."""

    __slots__ = ("blocks",)

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = tuple(blocks)

    @property
    def shape(self) -> torch.Size:
        b0 = self.blocks[0]
        return torch.Size((sum(b.shape[0] for b in self.blocks),) + tuple(b0.shape[1:]))

    @property
    def ndim(self) -> int:
        return self.blocks[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def devices(self) -> Mesh:
        return tuple(b.device for b in self.blocks)

    def to(self, device) -> torch.Tensor:
        dev = torch.device(device)
        return torch.cat([_copy(b, dev) for b in self.blocks])

    def cpu(self) -> torch.Tensor:
        return self.to("cpu")

    def __getitem__(self, i: int) -> torch.Tensor:
        i = int(i)
        for b in self.blocks:
            if i < b.shape[0]:
                return b[i]
            i -= b.shape[0]
        raise IndexError("ScenarioBlocks row index out of range")

    def __repr__(self) -> str:
        return f"ScenarioBlocks({tuple(self.shape)}, {self.dtype}, on {self.devices})"


def _is_leaf(x) -> bool:
    return not (
        isinstance(x, (dict, list, tuple))
        or (dataclasses.is_dataclass(x) and not isinstance(x, type))
    )


def _map(fn: Callable, tree, *rest, path: str = ""):
    """``fn(path, leaf, *other_leaves)`` over the leaves of parallel trees
    of dataclasses, dicts, tuples and lists."""
    if _is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {
            k: _map(fn, v, *(r[k] for r in rest), path=f"{path}[{k!r}]")
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map(fn, v, *(r[i] for r in rest), path=f"{path}[{i}]")
            for i, v in enumerate(tree)
        )
    return type(tree)(**{
        f.name: _map(
            fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest),
            path=f"{path}.{f.name}",
        )
        for f in dataclasses.fields(tree)
    })


def _rows(x) -> int | None:
    """Leading size of an array leaf with at least one axis, else None."""
    nd = getattr(x, "ndim", None)
    return None if not nd else int(x.shape[0])


def _laid_out(x, mesh: Mesh) -> bool:
    return (
        isinstance(x, ScenarioBlocks)
        and x.devices == mesh
        and len({b.shape[0] for b in x.blocks}) == 1
    )


def device_put_scenario(tree: Any, mesh: Mesh | None) -> Any:
    """Split every array leaf of ``tree`` with a leading axis into
    ``len(mesh)`` contiguous row blocks, block k on ``mesh[k]``
    (:class:`ScenarioBlocks`); scalars and None stay.  A leaf already laid
    out on ``mesh`` is kept; one laid out otherwise is gathered first.  A
    host leaf crosses to the first device once, and blocks on that same
    device are views of it.  The leading size must divide the mesh.  No-op
    when ``mesh`` is None."""
    if mesh is None:
        return tree
    n = len(mesh)

    def put(_, x):
        if _rows(x) is None:
            return x
        if isinstance(x, ScenarioBlocks):
            if _laid_out(x, mesh):
                return x
            x = x.to(mesh[0])
        x = torch.as_tensor(x)
        s = x.shape[0]
        if s % n:
            raise ValueError(
                f"{s} scenario rows do not divide the {n}-device scenario mesh"
            )
        if x.device.type != mesh[0].type:
            x = x.to(mesh[0])
        b = s // n
        return ScenarioBlocks(
            _copy(x[k * b:(k + 1) * b], d) for k, d in enumerate(mesh)
        )

    return _map(put, tree)


def gather_scenario(tree: Any, device=None) -> Any:
    """Every :class:`ScenarioBlocks` leaf gathered into one tensor on
    ``device`` (default: its first block's device); other leaves stay."""
    def gather(_, x):
        if not isinstance(x, ScenarioBlocks):
            return x
        return x.to(x.blocks[0].device if device is None else device)

    return _map(gather, tree)


def tree_to(tree: Any, device) -> Any:
    """Every tensor leaf of ``tree`` on ``device`` (a
    :class:`ScenarioBlocks` leaf gathered there); other leaves stay."""
    dev = torch.device(device)

    def move(_, x):
        return x.to(dev) if isinstance(x, (torch.Tensor, ScenarioBlocks)) else x

    return _map(move, tree)


def shard_of(tree: Any, k: int) -> Any:
    """Shard ``k`` of a laid-out tree: block k of every
    :class:`ScenarioBlocks` leaf, a plain tensor on mesh device k."""
    return _map(lambda _, x: x.blocks[k] if isinstance(x, ScenarioBlocks) else x, tree)


def join_shards(trees: Sequence[Any]) -> Any:
    """Inverse of :func:`shard_of`: per-shard trees of plain tensors (shard
    k's on mesh device k) joined into one tree of :class:`ScenarioBlocks`."""
    def join(_, *xs):
        return ScenarioBlocks(xs) if _rows(xs[0]) is not None else xs[0]

    return _map(join, trees[0], *trees[1:])


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


def scenario_layout_mismatches(tree: Any, mesh: Mesh | None) -> list[str]:
    """Tree paths of array leaves NOT split into equal row blocks on the
    devices of ``mesh`` in order (an empty list: correctly laid out).
    With ``mesh`` None any placement is accepted."""
    if mesh is None:
        return []
    bad: list[str] = []

    def check(path, x):
        if _rows(x) is None or _laid_out(x, mesh):
            return x
        where = (
            f"blocks of {[b.shape[0] for b in x.blocks]} rows on {x.devices}"
            if isinstance(x, ScenarioBlocks)
            else f"one {type(x).__name__} on {getattr(x, 'device', 'the host')}"
        )
        bad.append(f"{path}: {where}")
        return x

    _map(check, tree)
    return bad
