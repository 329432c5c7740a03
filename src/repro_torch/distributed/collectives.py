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
  pair (i, j); a member that receives nothing gets zeros.

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
"""

from __future__ import annotations

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
]


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
        full = blocks[0].new_empty(shape, device=out_devices[0])
        for b, off in zip(blocks, offsets):
            full[_slices(off, b.shape)].copy_(b)
        return tuple(full if i == 0 else _own(full, d) for i, d in enumerate(out_devices))

    @staticmethod
    def backward(ctx, *grads):
        tot = ordered_sum(grads, ctx.out_devices[0])
        if tot is None:
            return (None, None, None) + (None,) * len(ctx.sizes)
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
        tot = ordered_sum(xs, xs[0].device)
        parts = tot.chunk(len(xs), dim)
        ctx.part = (parts[0].shape, parts[0].dtype)
        return tuple(_own(p, d) for p, d in zip(parts, ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * (len(grads) + 1)
        zero = torch.zeros(ctx.part[0], dtype=ctx.part[1], device=ctx.devices[0])
        full = torch.cat([to_device(zero if g is None else g, ctx.devices[0]) for g in grads],
                         ctx.dim)
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
        tot = ordered_sum(xs, xs[0].device)
        return tuple(tot if i == 0 else _own(tot, d) for i, d in enumerate(ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        tot = ordered_sum(grads, ctx.devices[0])
        if tot is None:
            return (None,) * len(grads)
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
        for src, dst in perm:
            out[dst] = _own(xs[src], ctx.devices[dst])
        return tuple(torch.zeros_like(x) if o is None else o for x, o in zip(xs, out))

    @staticmethod
    def backward(ctx, *grads):
        back = [None] * len(grads)
        for src, dst in ctx.perm:
            if grads[dst] is not None:
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
