"""Plain PyTorch version of the flash-attention kernel: materialized causal
(optionally sliding-window) GQA attention in float32, as the reference's
oracle ``repro.kernels.flash_attention.ref.flash_ref`` computes it."""

from __future__ import annotations

import math

import torch

__all__ = ["flash_ref"]


def flash_ref(q, k, v, *, window=None):
    """q (B, S, H, D); k/v (B, S, K, D) with H = K * G. Returns (B, S, H, D).

    Causal mask; optional sliding window (positions within [i-window+1, i]).
    Computed in f32, returned in q.dtype.
    """
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return o.reshape(B, S, H, D).to(q.dtype)
