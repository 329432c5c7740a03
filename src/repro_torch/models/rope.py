"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

M-RoPE splits the head-dim half-pairs into (t, h, w) sections; each
section's rotation angle takes its coordinate from a (3, B, S) position
tensor.  With the same coordinate in all three (text-only input) it is
RoPE.
"""

from __future__ import annotations

import torch

__all__ = ["rope_frequencies", "apply_rope", "apply_mrope"]


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


def apply_mrope(x, positions3, theta: float, sections: tuple[int, ...]):
    """x: (B, S, H, hd); positions3: (3, B, S) int; ``sections`` sum to
    hd // 2 and give each frequency slot its coordinate (t, h or w)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim // 2 = {half}")
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(sections, device=x.device), output_size=half)
    pos = positions3[sec_id]  # (half, B, S): each slot's coordinate
    ang = torch.movedim(pos, 0, -1).float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    return _rotate(x, cos, sin)
