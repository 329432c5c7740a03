"""Collectives over a tuple of devices, differentiable (port only).

The reference gets its collectives from the compiler: GSPMD inserts the
all-gathers of FSDP, the reduce-scatters of their gradients and the
all-reduces of tensor parallelism, and ``jax.lax.ppermute`` moves a
pipeline stage's activations.  The port is single-controller: one
process drives every device of a mesh (repeats allowed: ``("cuda:0",) *
4`` is four virtual devices on one card), so a collective is a Python
function over one tensor a member device:

* :func:`all_gather` -- the members' blocks assembled into one tensor,
  a copy of it on each member (:func:`gather_blocks`: a grid of blocks,
  a copy on each of the devices asked for);
* :func:`reduce_scatter` -- the members' tensors summed, the sum split
  into equal blocks along a dimension, block k on member k;
* :func:`all_reduce` -- the members' tensors summed, a copy of the sum on
  each member;
* :func:`ppermute` -- tensor i copied to the device of member j for each
  pair (i, j); a member that receives nothing gets zeros;
* :func:`all_to_all` -- each member's tensor split into equal chunks along
  one dimension, chunk j sent to member j, the chunks a member receives
  concatenated in member order along another.

Each is a ``torch.autograd.Function`` whose backward is its dual: the
gradient of an all-gather is a reduce-scatter, and the reverse; that of an
all-reduce an all-reduce; that of a permutation the inverse permutation.
Every sum runs in member order on the group's first device
(:func:`ordered_sum`) and is then copied out: no atomics, and nothing
depends on the order in which autograd's device threads reach it, so a
step on a given mesh is bitwise repeatable.  A copy to a card is queued
on its stream; a copy to the host blocks, so the host never reads a
buffer that a queued copy has yet to fill.  Every output is a tensor of
its own, also where two members are one device.  Each call is a
``torch.profiler.record_function`` range (``collective.all_gather``, and
so on), in which its backward counts too.

No process group, NCCL or DTensor is involved: the chip host has one
card, and NCCL refuses two ranks on one GPU.

:func:`tally` counts the traffic: the reference parses its collectives
out of the compiled HLO (``collective_bytes``); here they are explicit, so
they count themselves.  Inside ``with tally() as t:`` every collective
above, forward and backward, records its per-member result bytes R and its
group size k, and ``t.per_device(n)`` gives the reference's per-device
numbers under its ring conventions (all-reduce 2R(k-1)/k, all-gather
R(k-1)/k, reduce-scatter R(k-1), all-to-all R(k-1)/k, permute R on the
link; R, R/k, Rk, R and R as the operand): the sum over every member of
every group, divided by the ``n`` devices of the mesh, which is what one
device's HLO gives for a symmetric program.  An :func:`ordered_sum`
outside a collective (the loss's row sums) is counted under its own key,
``ordered-sum``: k - 1 terms of R bytes cross to the summing device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
from torch.profiler import record_function

__all__ = [
    "to_device",
    "ordered_sum",
    "gather_blocks",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "ppermute",
    "all_to_all",
    "tally",
    "Tally",
    "record",
]


@dataclasses.dataclass
class Tally:
    """The collectives recorded inside :func:`tally`: per op, the operand
    and link bytes summed over every member of every group."""

    operand: dict = dataclasses.field(default_factory=dict)
    link: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, r: float, k: int, members: int) -> None:
        """``members`` members of a group of ``k``, each with a result of
        ``r`` bytes, under ``op``'s ring convention."""
        operand, link = {
            "all-reduce": (r, 2 * r * (k - 1) / k),
            "all-gather": (r / k, r * (k - 1) / k),
            "reduce-scatter": (r * k, r * (k - 1)),
            "all-to-all": (r, r * (k - 1) / k),
            "collective-permute": (r, r),
            "ordered-sum": (r * k, r * (k - 1)),
        }[op]
        self.operand[op] = self.operand.get(op, 0.0) + operand * members
        self.link[op] = self.link.get(op, 0.0) + link * members

    def per_device(self, n_devices: int) -> dict:
        """``{"operand_bytes", "link_bytes", "per_op"}`` per device of a
        mesh of ``n_devices`` (``per_op``: link bytes by op), the keys of
        the reference's ``collective_bytes``."""
        return {"operand_bytes": sum(self.operand.values()) / n_devices,
                "link_bytes": sum(self.link.values()) / n_devices,
                "per_op": {op: b / n_devices for op, b in self.link.items()}}


_TALLIES: list[Tally] = []
_DEPTH = [0]  # > 0 inside a collective: its ordered sums are its own


@contextlib.contextmanager
def tally():
    """Record every collective called inside the block, in the forward and
    in the backward (:class:`Tally`)."""
    t = Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def record(op: str, r: float, k: int, members: int) -> None:
    """Count ``members`` transfers of ``op`` (a key of :meth:`Tally.add`)
    in every open :func:`tally`: for traffic that moves by plain copies
    between devices (a halo exchange's planes)."""
    for t in _TALLIES:
        t.add(op, r, k, members)


@contextlib.contextmanager
def _collective(op: str, r: float, k: int, members: int):
    """Count one collective and mark its inner ordered sums as its own."""
    if _TALLIES and k > 1:
        record(op, r, k, members)
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev`` (``x`` itself when it is there): queued on the
    stream when ``dev`` is a card, a blocking copy to the host."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def _own(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev`` as a tensor of its own (a copy also when ``x`` is
    there already)."""
    y = to_device(x, dev)
    return y.clone() if y is x else y


def ordered_sum(xs: Sequence[torch.Tensor | None], dev: torch.device) -> torch.Tensor | None:
    """The sum of ``xs`` in order on ``dev``, a new tensor (None entries
    are zeros; None if every entry is)."""
    if _TALLIES and not _DEPTH[0]:
        given = [x for x in xs if x is not None]
        if len(given) > 1:
            record("ordered-sum", _nbytes(given[0]), len(given), 1)
    tot, terms = None, 0
    for x in xs:
        if x is None:
            continue
        x = to_device(x, dev)
        tot, terms = (x if tot is None else tot + x), terms + 1
    return tot.clone() if terms == 1 else tot


def _slices(offsets, sizes) -> tuple:
    return tuple(slice(o, o + s) for o, s in zip(offsets, sizes))


class _Gather(torch.autograd.Function):
    """Blocks placed at their offsets in a tensor of ``shape``; a copy on
    each of ``out_devices``.  Backward: the outputs' gradients summed in
    order on the first output device, each block's region sent back to
    its device (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, shape, offsets, out_devices, *blocks):
        ctx.offsets, ctx.out_devices = offsets, out_devices
        ctx.sizes = [tuple(b.shape) for b in blocks]
        ctx.block_devices = [b.device for b in blocks]
        k = len(blocks)
        with _collective("all-gather", math.prod(shape) * blocks[0].element_size(), k,
                         len(out_devices)):
            full = blocks[0].new_empty(shape, device=out_devices[0])
            for b, off in zip(blocks, offsets):
                full[_slices(off, b.shape)].copy_(b)
            return tuple(full if i == 0 else _own(full, d) for i, d in enumerate(out_devices))

    @staticmethod
    def backward(ctx, *grads):
        k = len(ctx.sizes)
        given = [g for g in grads if g is not None]
        r = _nbytes(given[0]) / k if given else 0
        with _collective("reduce-scatter", r, k, k if given else 0):
            tot = ordered_sum(grads, ctx.out_devices[0])
            if tot is None:
                return (None, None, None) + (None,) * k
            return (None, None, None) + tuple(
                to_device(tot[_slices(off, size)], dev)
                for off, size, dev in zip(ctx.offsets, ctx.sizes, ctx.block_devices))


def gather_blocks(blocks: Sequence[torch.Tensor], offsets: Sequence[tuple], shape,
                  out_devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """The general all-gather: ``blocks`` (disjoint, covering ``shape``)
    placed at their ``offsets`` (one start index a dimension), a copy of
    the whole on each of ``out_devices``.  Differentiable; its backward
    sums the outputs' gradients in order and returns each block's region."""
    with record_function("collective.all_gather"):
        return list(_Gather.apply(tuple(shape), tuple(tuple(o) for o in offsets),
                                  tuple(out_devices), *blocks))


def all_gather(blocks: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """The members' ``blocks`` concatenated along ``dim`` in member order,
    a copy on each member's device."""
    shape = list(blocks[0].shape)
    offsets, at = [], 0
    for b in blocks:
        off = [0] * b.ndim
        off[dim] = at
        offsets.append(off)
        at += b.shape[dim]
    shape[dim] = at
    return gather_blocks(blocks, offsets, shape, [b.device for b in blocks])


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.devices = dim, [x.device for x in xs]
        k = len(xs)
        with _collective("reduce-scatter", _nbytes(xs[0]) / k, k, k):
            tot = ordered_sum(xs, xs[0].device)
            parts = tot.chunk(k, dim)
            ctx.part = (parts[0].shape, parts[0].dtype)
            return tuple(_own(p, d) for p, d in zip(parts, ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * (len(grads) + 1)
        k = len(grads)
        with _collective("all-gather", math.prod(ctx.part[0]) * k * ctx.part[1].itemsize, k, k):
            zero = torch.zeros(ctx.part[0], dtype=ctx.part[1], device=ctx.devices[0])
            full = torch.cat([to_device(zero if g is None else g, ctx.devices[0])
                              for g in grads], ctx.dim)
            return (None,) + tuple(full if i == 0 else _own(full, d)
                                   for i, d in enumerate(ctx.devices))


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """The members' ``xs`` (one shape) summed in member order on the first
    member's device, the sum split into ``len(xs)`` equal blocks along
    ``dim``, block k on member k's device."""
    if xs[0].shape[dim] % len(xs):
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(xs[0].shape)} does not split "
                         f"into {len(xs)} blocks")
    with record_function("collective.reduce_scatter"):
        return list(_ReduceScatter.apply(dim, *xs))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        with _collective("all-reduce", _nbytes(xs[0]), len(xs), len(xs)):
            tot = ordered_sum(xs, xs[0].device)
            return tuple(tot if i == 0 else _own(tot, d) for i, d in enumerate(ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        given = [g for g in grads if g is not None]
        k = len(grads)
        with _collective("all-reduce", _nbytes(given[0]) if given else 0, k,
                         k if given else 0):
            tot = ordered_sum(grads, ctx.devices[0])
            if tot is None:
                return (None,) * k
            return tuple(tot if i == 0 else _own(tot, d) for i, d in enumerate(ctx.devices))


def all_reduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The members' ``xs`` summed in member order on the first member's
    device, a copy of the sum on each member's device."""
    with record_function("collective.all_reduce"):
        return list(_AllReduce.apply(*xs))


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, *xs):
        ctx.perm, ctx.devices = perm, [x.device for x in xs]
        out = [None] * len(xs)
        with _collective("collective-permute", _nbytes(xs[0]), len(xs), len(perm)):
            for src, dst in perm:
                out[dst] = _own(xs[src], ctx.devices[dst])
        return tuple(torch.zeros_like(x) if o is None else o for x, o in zip(xs, out))

    @staticmethod
    def backward(ctx, *grads):
        back = [None] * len(grads)
        moved = [(src, dst) for src, dst in ctx.perm if grads[dst] is not None]
        with _collective("collective-permute",
                         _nbytes(grads[moved[0][1]]) if moved else 0, len(grads), len(moved)):
            for src, dst in moved:
                back[src] = _own(grads[dst], ctx.devices[src])
        return (None, *back)


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """``xs[src]`` copied to the device of member ``dst`` for each (src,
    dst) of ``perm`` (each dst at most once); zeros for a member that
    receives nothing, as ``jax.lax.ppermute``."""
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a destination repeats in {perm}")
    with record_function("collective.ppermute"):
        return list(_PPermute.apply(tuple(perm), *xs))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, *xs):
        ctx.dims, ctx.devices = (split_dim, concat_dim), [x.device for x in xs]
        k = len(xs)
        with _collective("all-to-all", _nbytes(xs[0]), k, k):
            chunks = [x.chunk(k, split_dim) for x in xs]
            return tuple(torch.cat([to_device(c[j], d) for c in chunks], concat_dim)
                         for j, d in enumerate(ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * (len(grads) + 2)
        split_dim, concat_dim = ctx.dims
        like = next(g for g in grads if g is not None)
        grads = [torch.zeros_like(like, device=d) if g is None else g
                 for g, d in zip(grads, ctx.devices)]
        return (None, None, *_AllToAll.apply(concat_dim, split_dim, *grads))


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int
               ) -> list[torch.Tensor]:
    """Member i's ``xs[i]`` split into ``len(xs)`` equal chunks along
    ``split_dim``; member j gets chunk j of every member, concatenated in
    member order along ``concat_dim`` (``jax.lax.all_to_all``).
    Differentiable: the backward is the all-to-all with the two dims
    swapped."""
    if xs[0].shape[split_dim] % len(xs):
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(xs[0].shape)} does not split "
                         f"into {len(xs)} chunks")
    with record_function("collective.all_to_all"):
        return list(_AllToAll.apply(split_dim, concat_dim, *xs))
