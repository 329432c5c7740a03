"""Loop-aware analytic cost model of a PyTorch function, run on the meta
device (the reference's ``repro.launch.jaxpr_cost``, which walks a jaxpr;
the file keeps its name so that a reader finds the counterpart).

:func:`cost_of_fn` runs ``fn`` on meta tensors (shapes and dtypes only,
nothing allocated) under :class:`CostMode`, a ``TorchDispatchMode`` that
sees every ATen op below autograd, the backward's included, and counts
them by the reference's conventions (``src/repro/launch/jaxpr_cost.py``):

* flops -- a matrix product (mm, bmm, addmm, baddbmm, addbmm, mv, addmv,
  dot, a convolution) 2 x out x K (multiply-add = 2); every other op with
  a floating operand or result one flop per element of its largest
  operand; integer and boolean ops 0;
* bytes -- a fusion-aware lower bound of memory traffic: only the ops that
  must touch memory count, the products (every operand and the result) and
  the gathers and scatters (gather, scatter, index, index_put,
  index_select, embedding, cat, and the backward's slice and select
  scatters), which also go into ``gather_scatter_bytes``; elementwise
  chains are taken as fused into their consumers (0 bytes);
* views, reshapes, transposes, dtype casts, copies and factories (zeros,
  empty, full, arange) count nothing.

``torch.utils.flop_counter`` counts the products only, so it is not
enough here.  A Python loop runs each of its trips, so the reference's
scan multiplier comes for free; the port has no loop whose trip count
depends on data in a traced cell, so ``has_dynamic_loop`` stays False.

A hand-written kernel on a meta tensor returns an empty result and reports
its own analytic work (:func:`repro_torch.kernels._meta.charge`, to which
a counting :class:`CostMode` listens; the flash kernel its causal
pairs x 4 D forward and 2.5x that backward, PAop ``paop_flops_per_elem``
x NE): the counts ``chip_smoke.py`` bounds the kernels with.

:class:`CostMode` also tracks the storage its ops make and keep alive
(``peak_bytes``): a tensor's bytes count from the op that made its storage
until the last tensor that holds it is freed.  It is an estimate of the
trace's transient memory, not an allocator's measurement.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _meta

__all__ = ["JaxprCost", "CostMode", "cost_of_fn"]


@dataclasses.dataclass
class JaxprCost:
    flops: float = 0.0
    bytes: float = 0.0
    dot_flops: float = 0.0
    gather_scatter_bytes: float = 0.0
    has_dynamic_loop: bool = False

    def __add__(self, o: "JaxprCost") -> "JaxprCost":
        return JaxprCost(
            self.flops + o.flops,
            self.bytes + o.bytes,
            self.dot_flops + o.dot_flops,
            self.gather_scatter_bytes + o.gather_scatter_bytes,
            self.has_dynamic_loop or o.has_dynamic_loop,
        )

    def __mul__(self, k: float) -> "JaxprCost":
        return JaxprCost(
            self.flops * k,
            self.bytes * k,
            self.dot_flops * k,
            self.gather_scatter_bytes * k,
            self.has_dynamic_loop,
        )


_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot"}
_CONV = {"convolution", "_convolution"}
_MEM = {
    "gather", "scatter", "scatter_add", "scatter_reduce", "index", "index_put",
    "_index_put_impl", "index_select", "index_add", "index_copy", "index_fill",
    "embedding", "embedding_dense_backward", "cat", "stack", "take", "masked_scatter",
    "slice_scatter", "select_scatter", "slice_backward", "select_backward",
    "index_select_backward", "gather_backward",
}
_ZERO = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose", "permute",
    "expand", "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias", "detach",
    "_to_copy", "copy", "copy_", "clone", "contiguous", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "unfold", "view_as_real", "view_as_complex",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
    "new_full", "arange", "fill", "fill_", "zero", "zero_", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "movedim", "diagonal", "expand_as", "view_as", "flatten",
    "unflatten", "_unsafe_split", "split_copy", "resize_", "set_", "scalar_tensor",
}

# (op, argument signature) -> (result shapes, count), shared by every
# CostMode: the answers depend on the signature alone
_CACHE: dict = {}


def _name(func) -> str:
    return func._overloadpacket.__name__.rstrip("_") or func._overloadpacket.__name__


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors among an op's arguments or results (nested lists,
    tuples and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point or t.dtype.is_complex


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        a = args[1]
    else:
        a = args[0]
    if name in ("dot", "vdot"):
        return 2.0 * a.shape[0]
    if name == "addbmm":
        return 2.0 * out.numel() * a.shape[0] * a.shape[-1]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out: torch.Tensor) -> float:
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


def _cost(func, args, kwargs, out) -> tuple[float, float, float, float] | None:
    """(flops, bytes, dot_flops, gather_scatter_bytes) of one op, None for
    an op that counts nothing."""
    name = _name(func)
    if name in _ZERO:
        return None
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if name in _DOT or name in _CONV:
        f = _conv_flops(args, outs[0]) if name in _CONV else _dot_flops(name, args, outs[0])
        return f, sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs), f, 0.0
    if name == "convolution_backward":
        # grad_input and grad_weight: each the forward's product count
        f = 2.0 * args[0].numel() * math.prod(args[2].shape[1:])
        n = sum(t is not None for t in out[:2])
        return n * f, sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs), n * f, 0.0
    if name in _MEM:
        b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return 0.0, b, 0.0, b
    if any(_is_float(t) for t in ins + outs):
        return float(max(t.numel() for t in ins + outs)), 0.0, 0.0, 0.0
    return None


class CostMode(TorchDispatchMode):
    """Counts every ATen op run under it (:class:`JaxprCost` in ``cost``)
    and the peak of the storage its ops made that is still alive
    (``live_bytes``, ``peak_bytes``)."""

    def __init__(self):
        super().__init__()
        self.cost = JaxprCost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._holders: dict[int, list] = {}  # storage -> [bytes, live tensors]
        self._refs: dict = {}  # id of a holder's weak reference -> (it, storage)
        self._skip_storage: set[int] = set()

    def __enter__(self):
        _meta.LISTENERS.append(self._charge)
        return super().__enter__()

    def __exit__(self, *exc):
        _meta.LISTENERS.remove(self._charge)
        return super().__exit__(*exc)

    def _charge(self, flops: float, bytes: float) -> None:
        # a kernel's FLOPs are products (the flash kernel's scores and PV,
        # PAop's contractions), so they count as dot FLOPs too
        self.add(flops=flops, bytes=bytes, dot_flops=flops)

    def ignore_storage_of(self, tree) -> None:
        """Count no bytes for the storage of ``tree``'s tensors (the
        arguments: their memory is counted apart)."""
        for t in _tensors(tree):
            self._skip_storage.add(t.untyped_storage()._cdata)

    def add(self, flops: float = 0.0, bytes: float = 0.0, dot_flops: float = 0.0,
            gather_scatter_bytes: float = 0.0) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += bytes
        c.dot_flops += dot_flops
        c.gather_scatter_bytes += gather_scatter_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        """Run ``func`` and count it.  On meta tensors an op that makes new
        tensors runs once for each signature (shapes, strides, dtypes and
        its other arguments); later calls are answered with fresh empty
        tensors of the shapes it gave and the count it got: the meta
        kernels of elementwise ops are Python (0.1-1 ms a call), and a mesh
        program repeats each op on every device of every layer."""
        kwargs = kwargs or {}
        key = None
        if func.namespace == "aten" and not _aliases_input(func):
            try:
                key = (func, _signature(args), _signature(kwargs) if kwargs else ())
            except _Uncacheable:
                key = None
        hit = None if key is None else _CACHE.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            cost = _cost(func, args, kwargs, out)
            if key is not None:
                try:
                    _CACHE[key] = (_spec_of(out), cost)
                except _Uncacheable:
                    pass
        else:
            out, cost = _from_spec(hit[0]), hit[1]
        if cost is not None:
            self.add(*cost)
        self._track(func, out)
        return out

    # -- storage -------------------------------------------------------------
    def _track(self, func, out) -> None:
        alias = _aliases_input(func)
        for t in ((out,) if isinstance(out, torch.Tensor) else _tensors(out)):
            self._hold(t, t, alias)

    def _hold(self, t: torch.Tensor, holder, alias: bool = True) -> None:
        """Count ``t``'s storage live while ``holder`` lives: a new storage
        from an op that makes one (``alias`` False) adds its bytes; a view
        or a saved tensor of a counted storage holds it longer."""
        key = t.untyped_storage()._cdata
        if key in self._skip_storage:
            return
        h = self._holders.get(key)
        if h is None:
            if alias:
                return  # a view of something made before the trace
            h = self._holders[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += h[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        h[1] += 1
        ref = weakref.ref(holder, self._release)
        self._refs[id(ref)] = (ref, key)

    def _release(self, ref) -> None:
        _, key = self._refs.pop(id(ref), (None, None))
        h = self._holders.get(key)
        if h is None:
            return
        h[1] -= 1
        if h[1] == 0:
            self.live_bytes -= h[0]
            del self._holders[key]

    def saved_tensors(self):
        """``saved_tensors_hooks`` under which the tensors autograd saves for
        the backward hold their storage until the backward frees them
        (autograd keeps no Python object of them)."""
        def pack(t):
            held = _Held(t)
            self._hold(t, held)
            return held

        return torch.autograd.graph.saved_tensors_hooks(pack, lambda held: held.t)


class _Held:
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


@functools.lru_cache(maxsize=None)
def _aliases_input(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


class _Uncacheable(Exception):
    pass


def _signature(x):
    """A hashable key of an op's arguments: a meta tensor by its shape,
    strides and dtype; anything else that is not meta and hashable is
    refused (a real tensor's op runs)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncacheable
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, _PLAIN):
        return x
    raise _Uncacheable


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.memory_format, torch.layout)


def _spec_of(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), tuple(out.stride()), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_spec_of(v) for v in out))
    if out is None or isinstance(out, _PLAIN):
        return ("V", out)
    raise _Uncacheable


def _from_spec(spec):
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device="meta")
    if spec[0] == "V":
        return spec[1]
    return spec[0](_from_spec(v) for v in spec[1])


def _to_meta(tree: Any) -> Any:
    """``tree`` with every tensor replaced by an empty meta tensor of its
    shape, dtype and ``requires_grad``."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            m = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
            return m.requires_grad_(x.requires_grad)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x

    return conv(tree)


def cost_of_fn(fn, *args, **kwargs) -> JaxprCost:
    """Cost of ``fn(*args, **kwargs)`` run on meta stand-ins of its tensor
    arguments (global, unsharded numbers; a mesh program's per-device cost
    is this over the mesh size)."""
    args, kwargs = _to_meta(args), _to_meta(kwargs)
    with CostMode() as mode, mode.saved_tensors():
        fn(*args, **kwargs)
    return mode.cost
