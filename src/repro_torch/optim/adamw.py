"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine learning-rate schedule, on nested dicts of tensors (the
reference's ``repro.optim.adamw`` on pytrees).

Moments are float32 whatever the parameter dtype (bf16 training needs f32
first and second moments); the moment trees mirror the parameter tree.
:func:`adamw_update` works in place under ``torch.no_grad()``: parameters
and moments are overwritten, which is the port's form of the reference's
buffer donation (parameters and moments are the largest residents of the
card's memory).  The schedule, the bias corrections and the clip scale
stay 0-d tensors on the parameters' device, so a step makes no host sync.
The update is elementwise, so a leaf of more than ``SLICE_ELEMS`` elements
is updated in chunks along its leading axis (as many rows as fit
``SLICE_ELEMS``, at least one: a stacked leaf's layer): the same values,
with the f32 temporaries of one chunk instead of the leaf's (five f32
copies of an MoE's stacked expert weights would take more memory than the
weights and both moments).

On a mesh the leaves are ``Sharded`` (one block a mesh device, laid out by
``param_pspecs``): the moments mirror the parameters' blocks, the global
norm sums the squares of each *distinct* block once (the first replica of
each, in mesh order, a leaf after another, on the mesh's first device), the
clip scale, learning rate and bias corrections are copied to every device,
and each block is updated in place, in chunks as above.  So, given the same
gradients, each element's update is bitwise the unsharded one, and
replicas stay equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed.collectives import to_device
from repro_torch.distributed.sharding import Sharded

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "SLICE_ELEMS",
]

SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure: nested dicts (in
    the first tree's key order), lists and tuples (in index order)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_tree_map(fn, *(t[i] for t in trees)) for i in range(len(trees[0])))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in f32 (a 0-d
    tensor on ``step``'s device; a Python int gives one on the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict[str, Any]:
    """Zero f32 moments shaped like ``params`` (like each block of a
    ``Sharded`` leaf) and a 0-d int32 step, on the parameters' (first)
    device."""
    def zeros(p):
        if isinstance(p, Sharded):
            return Sharded([torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                            for b in p.blocks], p.spec, p.mesh, p.shape)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = next(_leaves(params))
    device = first.blocks[0].device if isinstance(first, Sharded) else first.device
    return {
        "m": _tree_map(zeros, params),
        "v": _tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in f32.  A
    ``Sharded`` leaf counts each distinct block once, summed on the mesh's
    first device in order."""
    parts = []
    for x in _leaves(tree):
        if isinstance(x, Sharded):
            parts += [x.blocks[k] for k in x.owners()]
        else:
            parts.append(x)
    dev = parts[0].device
    return torch.sqrt(sum(to_device(torch.linalg.vector_norm(x, dtype=torch.float32).square(),
                                    dev) for x in parts))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step, in place.  Returns (params, opt_state, metrics): the
    same trees, updated, and ``{"grad_norm", "lr"}`` as 0-d tensors."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd_part(p, g, m, v, decay: bool, scalars):
        scale, lr, bc1, bc2 = scalars
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay:
            delta.add_(p.to(torch.float32), alpha=cfg.weight_decay)
        p.copy_(p.to(torch.float32) - lr * delta)

    def upd_block(p, g, m, v, decay: bool, scalars):
        rows = max(SLICE_ELEMS // (p.numel() // p.shape[0]), 1)
        for i in range(0, p.shape[0], rows):
            upd_part(p[i:i + rows], g[i:i + rows], m[i:i + rows], v[i:i + rows], decay, scalars)

    # the scalars on each device that holds a block
    on = {scale.device: (scale, lr, bc1, bc2)}

    def upd(p, g, m, v):
        # decoupled weight decay on matrices only (ndim >= 2 of the whole
        # leaf), the usual exemption for norms and biases.
        decay = p.ndim >= 2
        if not isinstance(p, Sharded):
            upd_block(p, g, m, v, decay, on[scale.device])
            return
        for k, dev in enumerate(p.devices):
            if dev not in on:
                on[dev] = tuple(to_device(t, dev) for t in on[scale.device])
            upd_block(p.blocks[k], g.blocks[k], m.blocks[k], v.blocks[k], decay, on[dev])

    _tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
