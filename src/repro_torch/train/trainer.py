"""Training step factory: loss -> grad -> AdamW (the reference's
``repro.train.trainer``).

``make_train_step`` builds ``train_step(state, batch) -> (state, metrics)``.
The reference's is a pure function that XLA compiles and whose state buffers
it donates; here the step runs eagerly and updates the state in place
(:func:`repro_torch.optim.adamw.adamw_update`), which is the port's form of
that donation.  Gradients are taken with ``torch.autograd.grad`` and dropped
after the update, so no ``.grad`` stays on a parameter between steps.  One
card: the reference's ``act_spec``/``logits_spec`` sharding constraints have
no counterpart (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.profiler import record_function

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
        p.requires_grad_(True)
    return params


def train_state_init(generator: torch.Generator, cfg, opt_cfg: AdamWConfig | None = None,
                     params=None) -> TrainState:
    """Seeded random parameters on ``generator``'s device (or the given
    ``params``), zero moments, step 0.  ``opt_cfg`` is accepted for the
    reference's signature; the state does not depend on it."""
    params = _requires_grad(init_params(generator, cfg) if params is None else params)
    device = next(_leaves(params)).device
    return TrainState(params=params, opt_state=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(
    cfg,
    opt_cfg: AdamWConfig,
    *,
    remat: bool = True,
    grad_transform: Callable | None = None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) with metrics
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device.

    batch: ``tokens`` and ``labels`` integer tensors on the parameters'
    device (and ``vision_embeds`` for the VLM).  grad_transform: optional
    hook applied to the gradient tree before the optimizer (where gradient
    compression, :mod:`repro_torch.distributed.compression`, plugs in)."""

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


def _rebuild(like, leaves):
    """``like``'s structure (dicts, lists, tuples) with its leaves taken in
    order from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)
