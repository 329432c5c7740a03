"""Gradient compression (the reference's ``repro.distributed.compression``).

Plain functions on tensors and on nested dicts of tensors, so that they
plug into ``make_train_step(grad_transform=...)``:

* :func:`int8_compress` / :func:`int8_decompress` -- symmetric per-tensor
  int8 quantization (``torch.round``, like ``jnp.round``, rounds half to
  even);
* :func:`topk_compress` -- keep the entries with |g| at or above the k-th
  largest |g|, k = max(int(frac * numel), 1); ties at the threshold are all
  kept, as in the reference;
* :func:`make_error_feedback_transform` -- either compression with an
  error-feedback residual carried from step to step in float32.

On a mesh, ``make_train_step(mesh=...)`` applies the transform to each
device's tree of block gradients (per-tensor quantities such as the int8
scale are then per block).  The reference applies it inside one compiled
step before the gradient all-reduce; on the port's one-card host nothing
crosses a link, so what compression saves in bytes between cards is not
measured.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = [
    "int8_compress",
    "int8_decompress",
    "topk_compress",
    "make_error_feedback_transform",
]


def int8_compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale 0-d float)."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_compress(g: torch.Tensor, frac: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-``frac`` entries by magnitude (per tensor); returns
    (the kept values with zeros elsewhere, the boolean mask)."""
    flat = g.reshape(-1)
    k = max(int(frac * flat.numel()), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = g.abs() >= thresh
    return torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device)), mask


def _map_pairs(fn: Callable, a, b):
    """fn over the leaves of two trees of one structure (dicts, lists,
    tuples), each call giving a pair; returns the two trees of the pairs'
    halves."""
    if isinstance(a, dict):
        pairs = {k: _map_pairs(fn, a[k], b[k]) for k in a}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    if isinstance(a, (list, tuple)):
        pairs = [_map_pairs(fn, x, y) for x, y in zip(a, b)]
        return type(a)(p[0] for p in pairs), type(a)(p[1] for p in pairs)
    return fn(a, b)


def _zeros_like_f32(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like_f32(v) for v in tree)
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def make_error_feedback_transform(mode: str = "int8", frac: float = 0.01):
    """Returns (init_fn, transform_fn) for error-feedback compression.

    init_fn(grads_like) -> residual tree (float32 zeros)
    transform_fn(grads, residual) -> (compressed grads in the grads' dtypes,
    new residual)
    """
    if mode not in ("int8", "topk"):
        raise ValueError(mode)

    def one(g, r):
        g32 = g.to(torch.float32) + r
        if mode == "int8":
            out = int8_decompress(*int8_compress(g32))
        else:
            out, _ = topk_compress(g32, frac)
        return out.to(g.dtype), g32 - out

    def transform_fn(grads: Any, residual: Any):
        return _map_pairs(one, grads, residual)

    return _zeros_like_f32, transform_fn
