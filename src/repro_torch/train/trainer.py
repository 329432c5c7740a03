"""Training step factory: loss -> grad -> AdamW (the reference's
``repro.train.trainer``).

``make_train_step`` builds ``train_step(state, batch) -> (state, metrics)``.
The reference's is a pure function that XLA compiles and whose state buffers
it donates; here the step runs eagerly and updates the state in place
(:func:`repro_torch.optim.adamw.adamw_update`), which is the port's form of
that donation.  Gradients are taken with ``torch.autograd.grad`` and dropped
after the update, so no ``.grad`` stays on a parameter between steps.

``make_train_step(..., mesh=)`` steps a state laid out on an
:class:`~repro_torch.distributed.sharding.LMMesh` by ``state_pspecs``
(:func:`train_state_init` with ``mesh`` builds one): the batch is split
into row blocks by ``batch_pspec``; one ``torch.autograd.grad`` runs every
device's forward and backward (``models.transformer.mesh_loss_fn``), in
which each gathered leaf's gradient is reduce-scattered back to its blocks
in data order; a block replicated over an axis then gets the sum of its
replicas' gradients (``reduce_replicas``); ``grad_transform`` is applied to
each device's tree of block gradients; AdamW updates the blocks.  The
reference's ``act_spec`` and ``logits_spec`` are the port's ``P`` on that
mesh: ``act_pspec(axes)`` keeps each device's block of positions between
blocks (Megatron-SP; tensor-parallel blocks all-gather along the sequence
and reduce-scatter their outputs), ``P(dp, None, "model")`` runs the CE
vocab parallel.  The Mamba2, mLSTM and sLSTM mixers run tensor parallel
over ``model`` by heads where their heads split over it (each device its
heads' columns of the projections, the norm's sums all-reduced), under
either spec.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.profiler import record_function

from repro_torch.distributed.sharding import (
    Sharded,
    batch_pspec,
    param_pspecs,
    place,
    reduce_replicas,
    shard_of,
)
from repro_torch.models.transformer import _leaves, init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "train_state_init", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    params: Any  # nested dict of leaf tensors that require grad
    opt_state: Any  # {"m", "v": f32 trees like params, "step": 0-d int32}
    step: torch.Tensor  # 0-d int32


def _requires_grad(params):
    for p in _leaves(params):
        for b in (p.blocks if isinstance(p, Sharded) else (p,)):
            b.requires_grad_(True)
    return params


def train_state_init(generator: torch.Generator, cfg, opt_cfg: AdamWConfig | None = None,
                     params=None, mesh=None) -> TrainState:
    """Seeded random parameters on ``generator``'s device (or the given
    ``params``), zero moments, step 0.  With ``mesh`` the parameters are
    laid out on it by ``param_pspecs`` (drawn whole on ``generator``'s
    device, then split) and the moments made as zero blocks, so the state
    is the unsharded one, placed.  ``opt_cfg`` is accepted for the
    reference's signature; the state does not depend on it."""
    params = init_params(generator, cfg) if params is None else params
    if mesh is not None:
        params = place(params, param_pspecs(params, mesh), mesh)
    params = _requires_grad(params)
    first = next(_leaves(params))
    device = first.blocks[0].device if isinstance(first, Sharded) else first.device
    return TrainState(params=params, opt_state=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(
    cfg,
    opt_cfg: AdamWConfig,
    *,
    remat: bool = True,
    grad_transform: Callable | None = None,
    mesh=None,
    act_spec=None,
    logits_spec=None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) with metrics
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device (the
    mesh's first device).

    batch: ``tokens`` and ``labels`` integer tensors on the parameters'
    device (and ``vision_embeds`` for the VLM); with ``mesh``, tensors on
    any device or leaves already laid out by ``batch_pspec``.
    grad_transform: optional hook applied to the gradient tree before the
    optimizer (where gradient compression,
    :mod:`repro_torch.distributed.compression`, plugs in); on a mesh, to
    each device's tree of block gradients.  act_spec, logits_spec: the
    residual stream's and the CE logits' layout on ``mesh``
    (``models.transformer.mesh_loss_fn``); a spec without a mesh raises
    ``ValueError``."""
    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, remat, grad_transform, mesh, act_spec,
                                logits_spec)
    if act_spec is not None or logits_spec is not None:
        raise ValueError("act_spec and logits_spec lay activations out on a mesh: pass mesh=")

    def train_step(state: TrainState, batch):
        leaves = list(_leaves(state.params))
        with record_function("train.forward_backward"):
            loss = loss_fn(state.params, batch, cfg, remat=remat)
            grad_leaves = iter(torch.autograd.grad(loss, leaves))
        grads = _rebuild(state.params, grad_leaves)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with record_function("train.optimizer"):
            params, opt_state, om = adamw_update(opt_cfg, state.params, grads, state.opt_state)
        del grads, grad_leaves
        state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return state, {"loss": loss.detach(), **om}

    return train_step


def _mesh_train_step(cfg, opt_cfg, remat, grad_transform, mesh, act_spec, logits_spec
                     ) -> Callable:
    def train_step(state: TrainState, batch):
        if not all(isinstance(x, Sharded) for x in batch.values()):
            batch = place(batch, batch_pspec(mesh.axis_names, batch), mesh)
        shards = list(_leaves(state.params))
        with record_function("train.forward_backward"):
            loss = loss_fn(state.params, batch, cfg, remat=remat, mesh=mesh, act_spec=act_spec,
                           logits_spec=logits_spec)
            flat = iter(torch.autograd.grad(loss, [b for sh in shards for b in sh.blocks],
                                            allow_unused=True))
        with record_function("train.reduce_replicas"):
            grads = _rebuild(state.params, iter([
                Sharded(reduce_replicas(sh, [next(flat) for _ in sh.blocks]), sh.spec, mesh,
                        sh.shape) for sh in shards]))
        if grad_transform is not None:
            per_device = [list(_leaves(grad_transform(shard_of(grads, k))))
                          for k in range(mesh.size)]
            grads = _rebuild(state.params, iter([
                Sharded([pd[i] for pd in per_device], sh.spec, mesh, sh.shape)
                for i, sh in enumerate(shards)]))
        with record_function("train.optimizer"):
            params, opt_state, om = adamw_update(opt_cfg, state.params, grads, state.opt_state)
        del grads, flat
        state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return state, {"loss": loss.detach(), **om}

    return train_step


def _rebuild(like, leaves):
    """``like``'s structure (dicts, lists, tuples) with its leaves taken in
    order from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)
