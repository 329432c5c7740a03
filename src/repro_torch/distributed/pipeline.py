"""Pipeline parallelism over a mesh axis: the GPipe schedule (the
reference's ``repro.distributed.pipeline``).

The layer stack is split into ``n_stages`` contiguous groups
(:func:`split_stages`); stage ``s`` runs on the device at coordinate ``s``
of the pipeline axis (and 0 on the other axes).  The microbatch stream
enters stage 0; every tick each stage applies its layers to the
activation resident on it, and :func:`~repro_torch.distributed.collectives.ppermute`
copies the result to the next stage's device.  After ``n_micro + n_stages
- 1`` ticks every microbatch has traversed every stage; the bubble
fraction is the classic ``(n_stages - 1) / (n_micro + n_stages - 1)``.

The reference's tick, per stage, in the port's single-controller form:
stage 0 takes in microbatch t while the stream lasts; a stage whose
microbatch index ``t - s`` is out of range is inactive and keeps its
buffer (the reference computes and discards; the port skips the call);
the last stage writes each finished microbatch into its output slot.  The
stages' output buffers (zeros but the last's) are then summed in stage
order on the first stage's device (``psum`` over the axis), adding exact
zeros, so the result is bitwise the sequential apply of the stages to
each microbatch.  Everything is differentiable: the copies and the sum
are the collectives' autograd functions.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.collectives import all_reduce, ppermute, to_device
from repro_torch.distributed.sharding import LMMesh

__all__ = ["pipeline_apply", "split_stages", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def split_stages(stacked_params, n_stages: int):
    """Reshape stacked per-layer params (L, ...) -> (n_stages, L/S, ...)."""

    def reshape(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"split_stages: {L} layers do not split into {n_stages} stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))

    return _tree_map(reshape, stacked_params)


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    *,
    mesh: LMMesh,
    n_micro: int,
    axis: str = "pod",
) -> torch.Tensor:
    """Run x (B, ...) through the staged stack.

    stage_fn(stage_param_slice, microbatch) -> microbatch.
    stage_params: tree with a leading (n_stages, ...) axis; stage s's
    slice is copied to its device once a call.
    Returns the transformed batch on the first stage's device."""
    n_stages = mesh.shape[axis]
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"pipeline_apply: batch {B} does not split into {n_micro} microbatches")
    mb = B // n_micro
    devs = [mesh.flat[mesh.index({axis: s})] for s in range(n_stages)]
    params = [_tree_map(lambda a, s=s: to_device(a[s], devs[s]), stage_params)
              for s in range(n_stages)]
    xs = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    bufs = [torch.zeros_like(xs[0], device=d) for d in devs]
    outs: list = [None] * n_micro
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(n_micro + n_stages - 1):
        ys = []
        for s in range(n_stages):
            m = t - s  # microbatch index seen by stage s at tick t
            y = bufs[s]
            if 0 <= m < n_micro:
                inj = to_device(xs[t], devs[0]) if s == 0 else bufs[s]
                y = stage_fn(params[s], inj)
                if s == n_stages - 1:
                    outs[m] = y
            ys.append(y)
        bufs = ppermute(ys, fwd) if n_stages > 1 else ys
    last = torch.stack(outs)
    slots = [torch.zeros_like(last, device=d) for d in devs[:-1]] + [last]
    out = all_reduce(slots)[0] if n_stages > 1 else last
    return out.reshape(x.shape)
