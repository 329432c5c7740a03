"""Shared building blocks: norms, MLPs, init helpers.

``sinusoidal_positions`` waits for the audio family (ROADMAP.md, Queue 1
item 11).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "rmsnorm", "mlp_init", "mlp_apply"]


def dense_init(generator: torch.Generator, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init (LeCun-like): a standard normal cut to
    [-2, 2], times sigma = 1/sqrt(fan_in), drawn on ``generator``'s device."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (std * t).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, mlp_type: str, dtype):
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(generator, (d_model, d_ff), dtype),
            "w_up": dense_init(generator, (d_model, d_ff), dtype),
            "w_down": dense_init(generator, (d_ff, d_model), dtype),
        }
    if mlp_type == "gelu":
        return {
            "w_up": dense_init(generator, (d_model, d_ff), dtype),
            "w_down": dense_init(generator, (d_ff, d_model), dtype),
        }
    raise ValueError(mlp_type)


def mlp_apply(params, x, mlp_type: str):
    """Weights in the reference's (in, out) orientation: ``x @ w``."""
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
