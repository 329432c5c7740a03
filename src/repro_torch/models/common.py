"""Shared building blocks: norms, MLPs, sinusoidal positions, init helpers."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "rmsnorm", "mlp_apply", "sinusoidal_positions"]


def dense_init(generator: torch.Generator, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init (LeCun-like): a standard normal cut to
    [-2, 2], times sigma = 1/sqrt(fan_in), drawn on ``generator``'s device."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def mlp_apply(params, x, mlp_type: str):
    """Weights in the reference's (in, out) orientation: ``x @ w``."""
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


def sinusoidal_positions(positions, d_model: int, dtype):
    """Classic transformer sinusoidal embeddings (sin half, then cos half);
    positions (..., S) int -> (..., S, d_model), angles in f32."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
