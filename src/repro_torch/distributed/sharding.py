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
with the shard-aware chunk policy.

The LM side (the second half of this module) has the reference's FSDP +
Megatron-style rules verbatim: ``_RULES``, ``_spec_for``,
:func:`param_pspecs`, :func:`state_pspecs`, :func:`batch_pspec`,
:func:`decode_state_pspecs` and :func:`act_pspec`, over paths spelled as
``jax.tree_util.keystr`` prints them (``['blocks']['attn']['wq']``,
``['blocks'][5]['w_in']``), on tensors or on bare shapes (the tuples of
``models.transformer.param_shapes``, or tensors on the meta device), and
:class:`P`, a tuple that normalizes as jax's ``PartitionSpec``.  There is
no GSPMD to act on them, so the layout is explicit:

* :class:`LMMesh` -- a (data, model) or (pod, data, model) array of
  ``torch.device``, repeats allowed, with ``shape`` as ``{axis: size}``;
* :func:`place` -- every leaf split as jax's ``NamedSharding`` splits it
  (equal contiguous blocks in mesh order; a tuple part such as ``("pod",
  "data")`` over the product of its axes, the first major), one block on
  each mesh device (:class:`Sharded`; a replica is a copy of its own);
  :func:`gather` is the inverse, :func:`lm_layout_mismatches` the check;
* :func:`local_views` -- what a device computes with: the leaf gathered
  over every mesh axis but those kept (tensor and expert parallelism
  keep ``model``), through the differentiable collectives of
  :mod:`repro_torch.distributed.collectives`, so a leaf's gradient comes
  back reduce-scattered to its blocks; :func:`reduce_replicas` then sums
  it over the axes its spec leaves out.

Serving on a mesh lays the decode state out by :func:`decode_state_pspecs`
(:func:`sharded_zeros` allocates it block by block, :func:`own_part` cuts
a device's block out of what it computed); see
``models.transformer.mesh_prefill``.  Sequence parallelism (``act_pspec``'s
``model`` on the sequence axis) is computed by the train step
(``models.transformer.mesh_loss_fn(act_spec=)``): the residual stream
between blocks is each device's block of positions (:func:`mesh_block`,
the blocks :func:`place` makes), all-gathered over ``model`` into a block
(:func:`mesh_all_gather`) and reduce-scattered back out of it
(:func:`mesh_reduce_scatter`).  The recurrent mixers run tensor parallel
by heads in the train step: :func:`head_column_views` fetches each device
only the columns its heads read of a projection whose layout's column
blocks are not head-aligned, and :func:`mesh_rmsnorm` norms over channels
split across ``model``; serving on a mesh still gathers them whole.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.distributed.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    gather_blocks,
    reduce_scatter,
    to_device,
)

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
    "P",
    "act_pspec",
    "param_pspecs",
    "state_pspecs",
    "batch_pspec",
    "decode_state_pspecs",
    "LMMesh",
    "Sharded",
    "place",
    "gather",
    "lm_layout_mismatches",
    "local_views",
    "local_tree_views",
    "head_column_views",
    "reduce_replicas",
    "mesh_all_reduce",
    "mesh_all_gather",
    "mesh_all_to_all",
    "mesh_reduce_scatter",
    "mesh_block",
    "mesh_rmsnorm",
    "sharded_zeros",
    "own_part",
    "dp_axes",
]

Mesh = tuple[torch.device, ...]


def _card_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _mesh_device(d, what: str = "scenario mesh") -> torch.device:
    """``d`` as a mesh entry: a CPU device, the meta device (shapes only:
    the dry-run's stand-in for a card), or a CUDA card with its index that
    the host has."""
    dev = torch.device(d)
    if dev.type in ("cpu", "meta"):
        return torch.device(dev.type)
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    dev = torch.device("cuda", 0 if dev.index is None else dev.index)
    n = _card_count()
    if dev.index >= n:
        raise ValueError(f"{what} names {dev} but the host has {n} CUDA card(s)")
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


# ``x`` on ``dev``: queued on the stream when ``dev`` is a card, and a
# blocking copy to the host, whose reader may run at once (a non-blocking
# copy to the host lands in a pinned buffer later).
_copy = to_device


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
    :class:`ScenarioBlocks` (or :class:`Sharded`) leaf, a plain tensor on
    mesh device k."""
    return _map(lambda _, x: x.blocks[k] if isinstance(x, (ScenarioBlocks, Sharded)) else x,
                tree)


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


# ---------------------------------------------------------------------------
# The LM side: the reference's FSDP/TP rules (repro/distributed/sharding.py
# :240-400), the (data, model) mesh and the layout of a tree on it
# ---------------------------------------------------------------------------
def _norm_part(part):
    """A spec entry as jax's PartitionSpec keeps it: a 1-tuple is its axis,
    an empty tuple None."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else (part[0] if len(part) == 1 else part)
    return part


class P(tuple):
    """A partition spec: one entry a dimension, None, a mesh axis or a
    tuple of axes; ``tuple(P(...)) == tuple(PartitionSpec(...))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_norm_part(p) for p in parts))

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


# (regex over the tree path, trailing-dims sharding) -- first match wins.
# The tuple addresses the *last* len(tuple) dims of the leaf; leading dims
# (stacked layer axis, MoE expert axis, codebook axis) are unsharded by
# left-padding with None -- so one rule serves plain, stacked and
# expert-stacked variants of a matrix.  (The reference's, verbatim.)
_RULES: list[tuple[str, tuple]] = [
    # --- embeddings / head: vocab over model, d over data (fsdp)
    (r"embed", ("model", "data")),
    (r"lm_head", ("data", "model")),
    # --- attention
    (r"attn.*\['w[qkv]'\]", ("data", "model")),
    (r"attn.*\['b[qkv]'\]", ("model",)),
    (r"attn.*\['wo'\]", ("model", "data")),
    # --- mlp (dense and MoE expert-stacked; E is left-padded to None)
    (r"\['router'\]", (None, None)),
    (r"\['w_gate'\]", ("data", "model")),
    (r"\['w_up'\]", ("data", "model")),
    (r"\['w_down'\]", ("model", "data")),
    # --- ssm / mamba2 / mlstm mixers
    (r"mixer.*\['in_proj'\]", ("data", "model")),
    (r"mixer.*\['out_proj'\]", ("model", "data")),
    (r"mixer.*\['w[qkv]'\]", ("data", "model")),
    # --- xlstm sLSTM
    (r"\['w_in'\]", ("data", "model")),
    (r"\['w_out'\]", ("model", "data")),
]


def _is_shape(x) -> bool:
    return (isinstance(x, tuple) and not isinstance(x, P)
            and all(isinstance(s, (int, np.integer)) for s in x))


def _shape_of(leaf) -> tuple:
    """A leaf's shape: the leaf itself for a bare shape tuple."""
    return tuple(leaf) if _is_shape(leaf) else tuple(getattr(leaf, "shape", ()))


def _lm_container(x) -> bool:
    return (isinstance(x, (dict, list)) or (isinstance(x, tuple) and not _is_shape(x)
                                            and not isinstance(x, (P, _PerDevice)))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _lm_map(fn: Callable, tree, *rest, path: str = ""):
    """``fn(path, leaf, *other_leaves)`` over parallel trees of dicts,
    lists, tuples and dataclasses, paths as ``jax.tree_util.keystr``
    prints them; a shape tuple, a :class:`P` and a :class:`Sharded` are
    leaves."""
    if not _lm_container(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _lm_map(fn, v, *(r[k] for r in rest), path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_lm_map(fn, v, *(r[i] for r in rest), path=f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return type(tree)(**{
        f.name: _lm_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest),
                        path=f"{path}.{f.name}")
        for f in dataclasses.fields(tree)})


def act_pspec(mesh_axes: tuple[str, ...]) -> P:
    """Between-blocks residual layout: batch over dp, sequence over
    'model' (Megatron-SP).  ``mesh_loss_fn(act_spec=)`` computes it: each
    device keeps its block of positions between blocks, a tensor-parallel
    block (attention, MLP, a Mamba2 mixer by heads) all-gathers its normed
    input and reduce-scatters its output, any other block (the MoE, a
    mixer whose heads do not split) runs on the gathered sequence and keeps
    its block; the xLSTM gathers the sequence once, before its first
    block."""
    dp = tuple(a for a in mesh_axes if a in ("pod", "data"))
    return P(dp, "model", None)


def _spec_for(path: str, leaf, mesh_shape: dict | None = None) -> P:
    shape = _shape_of(leaf)
    nd = len(shape)
    # MoE expert weights: true expert parallelism (E over 'model') when the
    # expert count divides the axis; falls through to the d_ff-sharding
    # rules otherwise (e.g. 8 experts on a 16-wide axis).
    if mesh_shape is not None and re.search(r"moe.*\['w_(gate|up|down)'\]", path):
        e_ax = nd - 3
        if e_ax >= 0 and shape[e_ax] % mesh_shape.get("model", 1) == 0:
            parts = [None] * nd
            parts[e_ax] = "model"
            if shape[e_ax + 1] % mesh_shape.get("data", 1) == 0:
                parts[e_ax + 1] = "data"
            return P(*parts)
    for pat, trailing in _RULES:
        if re.search(pat, path):
            parts = [None] * max(nd - len(trailing), 0) + list(trailing)
            parts = parts[-nd:] if nd else []
            if mesh_shape is not None:
                parts = [a if (a is None or shape[i] % mesh_shape.get(a, 1) == 0) else None
                         for i, a in enumerate(parts)]
            return P(*parts)
    return P()  # replicated


def param_pspecs(params, mesh=None, tp: bool = True) -> Any:
    """The spec tree matching ``params`` (tensors, :class:`Sharded` leaves
    or bare shapes).  With ``mesh`` (anything whose ``shape`` is an
    ``{axis: size}`` dict) an axis that does not divide its dimension is
    dropped; ``tp=False`` drops the 'model' axis from every rule (the
    pure-DP layout)."""
    mesh_shape = dict(mesh.shape) if mesh is not None else None

    def drop_tp(spec: P) -> P:
        if tp:
            return spec
        return P(*[None if part == "model"
                   else (tuple(a for a in part if a != "model") or None)
                   if isinstance(part, tuple) else part
                   for part in spec])

    return _lm_map(lambda path, leaf: drop_tp(_spec_for(path, leaf, mesh_shape)), params)


def state_pspecs(state, mesh=None, tp: bool = True) -> Any:
    """Specs for a TrainState: moments mirror params; counters replicated."""
    from repro_torch.train.trainer import TrainState

    return TrainState(
        params=param_pspecs(state.params, mesh, tp),
        opt_state={"m": param_pspecs(state.opt_state["m"], mesh, tp),
                   "v": param_pspecs(state.opt_state["v"], mesh, tp),
                   "step": P()},
        step=P(),
    )


def batch_pspec(mesh_axes: tuple[str, ...], batch: Any) -> Any:
    """Shard the global-batch dim over the data(+pod) axes."""
    dp = tuple(a for a in mesh_axes if a in ("pod", "data"))
    return _lm_map(lambda _, leaf: P(dp, *(None,) * (len(_shape_of(leaf)) - 1)), batch)


def decode_state_pspecs(state, mesh_axes: tuple[str, ...], cfg=None, mesh=None) -> Any:
    """KV caches / recurrent states: batch over data(+pod), and axis 2
    (the kv cache's sequence, a Mamba2 state's heads) over 'model', else
    the first trailing axis that divides it.  Stacked states carry a
    leading layer axis, so batch is axis 1; xLSTM states (a list a layer)
    have batch at axis 0.  Works on shapes: ``init_decode_state(...,
    device="meta")`` allocates nothing."""
    dp = tuple(a for a in mesh_axes if a in ("pod", "data"))
    mesh_shape = dict(mesh.shape) if mesh is not None else {}
    model_size = mesh_shape.get("model", 1)
    batch_axis = 0 if (cfg is not None and cfg.block_pattern == "xlstm") else 1

    def spec(_, leaf):
        shape = _shape_of(leaf)
        nd = len(shape)
        if nd <= batch_axis:
            return P(*(None,) * nd)
        parts: list = [None] * nd
        if shape[batch_axis] % max(math.prod(mesh_shape.get(a, 1) for a in dp), 1) == 0:
            parts[batch_axis] = dp
        if nd >= 4 and model_size > 1:
            for ax in (2, nd - 2, nd - 1):
                if ax == batch_axis:
                    continue
                if shape[ax] % model_size == 0 and shape[ax] >= model_size:
                    parts[ax] = "model"
                    break
        return P(*parts)

    return _lm_map(spec, state)


class LMMesh:
    """A mesh of torch devices for the LM side: ``devices``, an array with
    one axis a name of ``axis_names`` (the reference's ``("data",
    "model")`` or ``("pod", "data", "model")``), repeats allowed
    (``("cpu",) * 4`` shaped (2, 2) is four virtual devices).  ``shape``
    is ``{axis: size}`` as ``dict(jax_mesh.shape)``; device ``k`` of
    ``flat`` is the k-th in row-major order.  A CUDA device that the host
    lacks raises, naming the host's count."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if src.ndim != len(self.axis_names) or len(set(self.axis_names)) != src.ndim:
            raise ValueError(f"mesh of shape {src.shape} with axes {self.axis_names}")
        if src.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            self.devices[idx] = _mesh_device(src[idx], "mesh")
        if len({d.type for d in self.devices.flat}) != 1:
            raise ValueError(f"mesh mixes device types: {self.flat}")
        self._dims = dict(zip(self.axis_names, src.shape))
        self._coords = [dict(zip(self.axis_names, (int(c) for c in idx)))
                        for idx in np.ndindex(src.shape)]
        self._groups: dict = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(self._dims)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> tuple[torch.device, ...]:
        return tuple(self.devices.flat)

    def coords(self, k: int) -> dict[str, int]:
        """The mesh coordinates of device ``k`` of ``flat``, by axis."""
        return self._coords[k]

    def index(self, coords: dict[str, int]) -> int:
        k = 0
        for a in self.axis_names:
            k = k * self._dims[a] + coords.get(a, 0)
        return k

    def group(self, k: int, axes: Sequence[str]) -> list[int]:
        """The devices that agree with device ``k`` on every axis but
        ``axes``, ordered by their coordinates along ``axes`` (the first
        axis major): the members of a collective over ``axes``."""
        key = (k, tuple(axes))
        if key not in self._groups:
            c = self.coords(k)
            self._groups[key] = [
                self.index({**c, **dict(zip(axes, combo))})
                for combo in itertools.product(*(range(self._dims[a]) for a in axes))]
        return self._groups[key]

    def leaders(self) -> list[int]:
        """The first model device of each data row (model coordinate 0)."""
        return [k for k in range(self.size) if self.coords(k).get("model", 0) == 0]

    def __eq__(self, other) -> bool:
        return (isinstance(other, LMMesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape and self.flat == other.flat)

    def __repr__(self) -> str:
        return f"LMMesh({self.shape}, {[str(d) for d in self.flat]})"


def _parts(spec, nd: int) -> list[tuple[str, ...]]:
    """The mesh axes of each of ``nd`` dims (a dim past the spec's end is
    replicated, as in jax)."""
    out = []
    for i in range(nd):
        part = spec[i] if i < len(spec) else None
        out.append(() if part is None else (part,) if isinstance(part, str) else tuple(part))
    return out


def _region(mesh: LMMesh, k: int, parts, shape) -> tuple[list[int], list[int]]:
    """Offsets and sizes of device ``k``'s block of a leaf of ``shape``."""
    c = mesh.coords(k)
    offs, sizes = [], []
    for n, axes in zip(shape, parts):
        idx, cnt = 0, 1
        for a in axes:
            idx, cnt = idx * mesh.shape[a] + c[a], cnt * mesh.shape[a]
        offs.append(idx * (n // cnt))
        sizes.append(n // cnt)
    return offs, sizes


def _sl(offs, sizes) -> tuple:
    return tuple(slice(o, o + s) for o, s in zip(offs, sizes))


class Sharded:
    """A leaf laid out on an :class:`LMMesh` by ``spec``: ``blocks[k]``
    on ``mesh.flat[k]``, one block a mesh device (a replica is a copy of
    its own).  ``full(device)`` assembles it."""

    __slots__ = ("blocks", "spec", "mesh", "shape")

    def __init__(self, blocks, spec, mesh: LMMesh, shape):
        self.blocks = tuple(blocks)
        self.spec = P(*spec)
        self.mesh = mesh
        self.shape = torch.Size(shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(b.device for b in self.blocks)

    def numel(self) -> int:
        return math.prod(self.shape)

    def parts(self) -> list[tuple[str, ...]]:
        return _parts(self.spec, self.ndim)

    def owners(self) -> list[int]:
        """The first device (in mesh order) of each distinct block."""
        seen, out = set(), []
        for k in range(self.mesh.size):
            key = tuple(_region(self.mesh, k, self.parts(), self.shape)[0])
            if key not in seen:
                seen.add(key)
                out.append(k)
        return out

    def replica_axes(self) -> tuple[str, ...]:
        """The mesh axes the spec leaves out: the blocks are replicated
        over them."""
        used = {a for part in self.parts() for a in part}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    @torch.no_grad()
    def full(self, device=None) -> torch.Tensor:
        dev = self.mesh.flat[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for k in self.owners():
            out[_sl(*_region(self.mesh, k, self.parts(), self.shape))].copy_(self.blocks[k])
        return out

    def unbind(self) -> list["Sharded"]:
        """A stacked leaf's layers (its leading axis, which no rule
        shards), as views of the blocks: the gradient of the stack is one
        ``torch.stack`` a block."""
        if self.parts()[0]:
            raise ValueError(f"unbind: the leading axis is sharded ({self.spec})")
        per = [torch.unbind(b) for b in self.blocks]
        spec = P(*tuple(self.spec)[1:])
        return [Sharded([p[i] for p in per], spec, self.mesh, self.shape[1:])
                for i in range(self.shape[0])]

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, on {self.mesh})"


def _place_leaf(path: str, x: torch.Tensor, spec, mesh: LMMesh) -> Sharded:
    parts = _parts(spec, x.ndim)
    for i, axes in enumerate(parts):
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[i] % n:
            raise ValueError(f"{path}: dim {i} of {tuple(x.shape)} does not divide the "
                             f"{n} blocks of {spec} on {mesh.shape}")
    blocks = []
    for k, dev in enumerate(mesh.flat):
        offs, sizes = _region(mesh, k, parts, x.shape)
        b = torch.empty(sizes, dtype=x.dtype, device=dev)
        b.copy_(x[_sl(offs, sizes)])
        blocks.append(b.requires_grad_(x.requires_grad))
    return Sharded(blocks, spec, mesh, x.shape)


def place(tree: Any, specs: Any, mesh: LMMesh) -> Any:
    """Every array leaf of ``tree`` laid out on ``mesh`` by its spec in
    ``specs`` (a parallel tree): one :class:`Sharded` leaf, each block a
    tensor of its own on its device (a leaf that requires grad gives
    blocks that do).  Full tensors may sit on any device (numpy arrays
    are taken as tensors); a :class:`Sharded` leaf of another mesh or spec
    is gathered on the new mesh's first device first, one already laid
    out so is kept.  A 0-d leaf (a counter) becomes a tensor of its own
    on the mesh's first device; other leaves stay."""
    first = mesh.flat[0]

    def put(path, x, spec):
        if isinstance(x, Sharded):
            if x.mesh == mesh and tuple(x.spec) == tuple(P(*spec)):
                return x
            x = x.full(first).requires_grad_(x.blocks[0].requires_grad)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim == 0:
            return x.detach().to(first, copy=True)
        return _place_leaf(path, x, spec, mesh)

    with torch.no_grad():
        return _lm_map(put, tree, specs)


def gather(tree: Any, device=None) -> Any:
    """The inverse of :func:`place`: every :class:`Sharded` leaf assembled
    into one tensor on ``device`` (default: its mesh's first device), and
    every other tensor leaf moved there when ``device`` is given."""
    def get(_, x):
        if isinstance(x, Sharded):
            return x.full(device)
        if device is not None and isinstance(x, torch.Tensor):
            return x.detach().to(device)
        return x

    return _lm_map(get, tree)


def lm_layout_mismatches(tree: Any, mesh: LMMesh, specs: Any = None) -> list[str]:
    """Tree paths of array leaves (of at least one axis) NOT laid out on
    ``mesh``: not a :class:`Sharded` leaf of this mesh, a block not on its
    device or not of its region's shape, or (with ``specs``) a spec other
    than the one given (an empty list: correctly laid out)."""
    bad: list[str] = []

    def check(path, x, *spec):
        if not getattr(x, "ndim", 0):
            return x
        if not isinstance(x, Sharded) or x.mesh != mesh:
            where = getattr(x, "mesh", None) or getattr(x, "device", "the host")
            bad.append(f"{path}: one {type(x).__name__} on {where}")
            return x
        if spec and tuple(P(*spec[0])) != tuple(x.spec):
            bad.append(f"{path}: spec {x.spec}, expected {P(*spec[0])}")
        for k, b in enumerate(x.blocks):
            size = _region(mesh, k, x.parts(), x.shape)[1]
            if b.device != mesh.flat[k] or list(b.shape) != size:
                bad.append(f"{path}: block {k} {tuple(b.shape)} on {b.device}, expected "
                           f"{tuple(size)} on {mesh.flat[k]}")
                break
        return x

    _lm_map(check, tree, *(() if specs is None else (specs,)))
    return bad


def local_views(sh: Sharded, keep: Sequence[str] = (), at: Sequence[int] | None = None
                ) -> list[torch.Tensor]:
    """What each device of ``at`` (default: every mesh device, in order)
    computes with: the leaf gathered over every spec axis not in ``keep``
    (``keep=("model",)``: a tensor-parallel device's column or row block,
    an expert-parallel device's experts; ``()``: the whole leaf).  A
    device whose gather group is itself gets its block as is; otherwise
    the group's blocks go through one differentiable all-gather, whose
    backward reduce-scatters the gradient to them in group order."""
    mesh, parts = sh.mesh, sh.parts()
    at = list(range(mesh.size)) if at is None else list(at)
    dims = [i for i, axes in enumerate(parts) if axes and not set(axes) <= set(keep)]
    axes = [a for i in dims for a in parts[i]]
    if not axes or math.prod(mesh.shape[a] for a in axes) == 1:
        return [sh.blocks[k] for k in at]
    wanted, views = set(at), {}
    for k in at:
        if k in views:
            continue
        group = mesh.group(k, axes)
        out = [g for g in group if g in wanted]
        shape, offsets = list(sh.blocks[k].shape), []
        for g in group:
            offs, sizes = _region(mesh, g, parts, sh.shape)
            offsets.append([offs[i] if i in dims else 0 for i in range(sh.ndim)])
        for i in dims:
            shape[i] = sh.shape[i]
        got = gather_blocks([sh.blocks[g] for g in group], offsets, shape,
                            [mesh.flat[g] for g in out])
        views.update(zip(out, got))
    return [views[k] for k in at]


def _merged(ranges) -> tuple[tuple[int, int], ...]:
    """``ranges`` in their order, each range that starts where the one
    before it stops joined to it."""
    out: list[list[int]] = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1][1] = b
        else:
            out.append([a, b])
    return tuple((a, b) for a, b in out)


def head_column_views(sh: Sharded, ranges: Sequence, dim: int = -1,
                      at: Sequence[int] | None = None) -> list[torch.Tensor]:
    """What each device of ``at`` (default: every mesh device) computes with
    under tensor parallelism by heads: the leaf gathered over every axis of
    its spec, restricted along ``dim`` to device k's ``ranges[k]``
    (half-open (start, stop) pairs, their pieces in that order).  Only
    those ranges move: each member of the leaf's gather group gives the
    narrowed pieces of its block that fall inside them, through one
    differentiable :func:`~repro_torch.distributed.collectives.gather_blocks`
    for each distinct request (the devices that ask the same ranges of the
    same group share it), whose backward sums the requesters' gradients in
    order and returns each piece's region to its block.  A request that
    the device's own block holds (a replicated leaf, or its own row or
    column block) is a view of it, or the concatenation of its pieces: no
    collective."""
    mesh, parts = sh.mesh, sh.parts()
    dim %= sh.ndim
    at = list(range(mesh.size)) if at is None else list(at)
    axes = [a for part in parts for a in part]
    jobs: dict = {}
    for k in at:
        group = tuple(mesh.group(k, axes)) if axes else (k,)
        jobs.setdefault((group, _merged(ranges[k])), []).append(k)
    views: dict[int, torch.Tensor] = {}
    for (group, want), dests in jobs.items():
        owners, pieces, offsets, pos = set(), [], [], 0
        for a, b in want:
            for g in group:
                offs, sizes = _region(mesh, g, parts, sh.shape)
                lo, hi = max(a, offs[dim]), min(b, offs[dim] + sizes[dim])
                if lo < hi:
                    owners.add(g)
                    pieces.append(sh.blocks[g].narrow(dim, lo - offs[dim], hi - lo))
                    offsets.append([pos + lo - a if i == dim else o for i, o in enumerate(offs)])
            pos += b - a
        if len(dests) == 1 and owners == {dests[0]}:
            views[dests[0]] = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
            continue
        shape = list(sh.shape)
        shape[dim] = pos
        views.update(zip(dests, gather_blocks(pieces, offsets, shape,
                                              [mesh.flat[d] for d in dests])))
    return [views[k] for k in at]


@torch.no_grad()
def reduce_replicas(sh: Sharded, grads: Sequence[torch.Tensor | None]) -> list[torch.Tensor]:
    """Per-device gradients of ``sh``'s blocks (None: zeros) summed over
    the mesh axes its spec leaves out, in group order on each group's first
    device, the sum copied to every member: the gradient of a replicated
    block is the sum of its replicas' (each device's use of its copy)."""
    grads = [torch.zeros_like(b) if g is None else g for b, g in zip(sh.blocks, grads)]
    return _over_groups(grads, sh.mesh, sh.replica_axes(), all_reduce)


class _PerDevice(tuple):
    """One entry a device: a leaf of :func:`_lm_map`, not a container."""


def local_tree_views(tree: Any, keep: Sequence[str] = (), at: Sequence[int] | None = None
                     ) -> list[Any]:
    """:func:`local_views` of every :class:`Sharded` leaf of ``tree``: one
    tree of tensors for each device of ``at`` (default: every mesh
    device)."""
    views = _lm_map(lambda _, sh: _PerDevice(local_views(sh, keep, at)), tree)
    n = len(_lm_items(views)[0][1])
    return [_lm_map(lambda _, v: v[i], views) for i in range(n)]


def _lm_items(tree):
    out: list = []
    _lm_map(lambda path, x: out.append((path, x)), tree)
    return out


def mesh_all_reduce(xs: Sequence[torch.Tensor], mesh: LMMesh,
                    axes: Sequence[str] = ("model",)) -> list[torch.Tensor]:
    """Each mesh device's ``xs`` entry all-reduced over ``axes`` (in group
    order on the group's first device), a sum on every member."""
    return _over_groups(xs, mesh, axes, all_reduce)


def mesh_all_gather(xs: Sequence[torch.Tensor], mesh: LMMesh, dim: int,
                    axes: Sequence[str] = ("model",)) -> list[torch.Tensor]:
    """Each mesh device's ``xs`` entry concatenated along ``dim`` over
    ``axes`` in group order, a copy on every member."""
    return _over_groups(xs, mesh, axes, lambda group: all_gather(group, dim))


def mesh_all_to_all(xs: Sequence[torch.Tensor], mesh: LMMesh, split_dim: int, concat_dim: int,
                    axes: Sequence[str] = ("model",)) -> list[torch.Tensor]:
    """Each mesh device's ``xs`` entry through an all-to-all over ``axes``
    (:func:`~repro_torch.distributed.collectives.all_to_all`)."""
    return _over_groups(xs, mesh, axes, lambda group: all_to_all(group, split_dim, concat_dim))


def mesh_reduce_scatter(xs: Sequence[torch.Tensor], mesh: LMMesh, dim: int,
                        axes: Sequence[str] = ("model",)) -> list[torch.Tensor]:
    """Each mesh device's ``xs`` entry summed over ``axes`` in group order,
    the sum split along ``dim`` into equal blocks, member i's block on
    member i (:func:`~repro_torch.distributed.collectives.reduce_scatter`,
    whose backward is the all-gather)."""
    return _over_groups(xs, mesh, axes, lambda group: reduce_scatter(group, dim))


def mesh_rmsnorm(xs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor], mesh: LMMesh,
                 eps: float, axes: Sequence[str] = ("model",)) -> list[torch.Tensor]:
    """``models.common.rmsnorm`` of the concatenation over ``axes`` (in
    group order) of the devices' equal blocks of channels ``xs`` (one a
    mesh device; the last dimension), each device's block scaled by its
    ``scales`` block: each device sums the squares of its channels in
    float32, the sums are all-reduced over ``axes`` in member order, and
    their mean is over the whole width.  Returns each device's block."""
    xf = [x.float() for x in xs]
    sums = mesh_all_reduce([(f * f).sum(dim=-1, keepdim=True) for f in xf], mesh, axes)
    width = xs[0].shape[-1] * math.prod(mesh.shape[a] for a in axes)
    return [(f * torch.rsqrt(s / width + eps) * sc.float()).to(x.dtype)
            for x, f, s, sc in zip(xs, xf, sums, scales)]


def mesh_block(x: torch.Tensor, mesh: LMMesh, k: int, dim: int,
               axes: Sequence[str] = ("model",)) -> torch.Tensor:
    """Device ``k``'s block of ``x`` along ``dim``: ``x`` split into equal
    contiguous blocks over ``axes`` (the first major), in mesh order, as
    :func:`place` splits a leaf; a view."""
    c, idx, cnt = mesh.coords(k), 0, 1
    for a in axes:
        idx, cnt = idx * mesh.shape[a] + c[a], cnt * mesh.shape[a]
    n = x.shape[dim] // cnt
    return x.narrow(dim, idx * n, n)


def dp_axes(mesh: LMMesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes: ``pod`` and ``data``, those it has."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def sharded_zeros(tree: Any, specs: Any, mesh: LMMesh) -> Any:
    """Every tensor leaf of ``tree`` (a meta tensor is enough: only its
    shape and dtype are read) as a :class:`Sharded` leaf of zero blocks
    laid out by its spec, each block allocated on its device (on a meta
    mesh, nothing is allocated)."""
    def put(_, x, spec):
        parts = _parts(spec, x.ndim)
        blocks = [torch.zeros(_region(mesh, k, parts, x.shape)[1], dtype=x.dtype, device=d)
                  for k, d in enumerate(mesh.flat)]
        return Sharded(blocks, spec, mesh, x.shape)

    return _lm_map(put, tree, specs)


def own_part(sh: Sharded, k: int, local: torch.Tensor, keep: Sequence[str] = ()) -> torch.Tensor:
    """Device ``k``'s block of ``sh``, cut out of ``local``: what device k
    holds of the leaf gathered over every spec axis not in ``keep`` (the
    shape of ``local_views(sh, keep)[k]``)."""
    offs, sizes = _region(sh.mesh, k, sh.parts(), sh.shape)
    return local[tuple(slice(None) if set(axes) <= set(keep) else slice(o, o + n)
                       for axes, o, n in zip(sh.parts(), offs, sizes))]


def _over_groups(xs, mesh: LMMesh, axes, fn) -> list[torch.Tensor]:
    """``fn`` (a collective over a group's entries) over each group of
    devices that differ only on ``axes``; ``xs`` as is on a group of one."""
    if math.prod(mesh.shape.get(a, 1) for a in axes) == 1:
        return list(xs)
    out: dict[int, torch.Tensor] = {}
    for k in range(mesh.size):
        if k not in out:
            group = mesh.group(k, axes)
            out.update(zip(group, fn([xs[g] for g in group])))
    return [out[k] for k in range(mesh.size)]
