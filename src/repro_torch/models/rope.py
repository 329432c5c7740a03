"""Rotary position embeddings (standard RoPE).

``apply_mrope`` (Qwen2-VL's M-RoPE) waits for the VLM configuration
(ROADMAP.md, Queue 1 item 11).
"""

from __future__ import annotations

import torch

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(head_dim: int, theta: float, dtype=torch.float32, device=None):
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent).to(dtype)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int.  The angles are f32; cos
    and sin are cast to x.dtype before the rotation, as in the reference."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)  # (B, S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    return _rotate(x, cos, sin)
