"""Plain PyTorch versions of the flash-attention kernels: materialized
causal (optionally sliding-window) GQA attention in float32, as the
reference's oracle ``repro.kernels.flash_attention.ref.flash_ref`` computes
it, and its gradient (:func:`flash_bwd_ref`), the backward kernel's plain
version, with the measure a backward is held to (:func:`flash_bwd_errors`)."""

from __future__ import annotations

import math

import torch

__all__ = ["flash_ref", "flash_bwd_ref", "flash_bwd_errors", "BWD_TOL", "BWD_ROW_REL",
           "BWD_ROW_FLOOR"]

# A backward (dq, dk, dv) against flash_bwd_ref, on unit-normal inputs.
# f32: 1e-4 of the largest |plain| of the three (reads ~5e-7 on an H100).
# bf16 also row by row: ||x - ref|| / (||ref|| + BWD_ROW_FLOOR * rms row
# norm) over each (b, s, head) row of D values, the rms over the rows of all
# three.  The floor keeps rows whose exact gradient vanishes (dq and dk where
# a query sees one key: P = 1 and dS = 0) from dividing by rounding noise.
# P and dS rounded to bf16 as mma operands read ~5e-3 of max and per row; a
# dropped or doubled tile of 64 of n keys or queries reads about
# sqrt(64 / n), 0.125 at n = 4096.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_ROW_REL, BWD_ROW_FLOOR = 2e-2, 1e-2


def flash_ref(q, k, v, *, window=None):
    """q (B, S, H, D); k/v (B, S, K, D) with H = K * G. Returns (B, S, H, D).

    Causal mask; optional sliding window (positions within [i-window+1, i]).
    Computed in f32, returned in q.dtype.
    """
    B, S, H, D = q.shape
    p = _probs(q, k, window)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def _probs(q, k, window):
    """Softmax probabilities (B, K, G, S, S) in f32 under the causal (and
    window) mask."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)


def flash_bwd_ref(q, k, v, o, do, *, window=None):
    """Gradient of :func:`flash_ref` at (q, k, v) for the output gradient
    ``do``, given the forward's output ``o``.  q, o, do (B, S, H, D); k/v
    (B, S, K, D).  Returns (dq, dk, dv) in the inputs' dtypes.

    The materialized f32 formulas the backward kernel computes tile by tile:
    P = softmax(q k^T / sqrt(D)) under the mask, dV = P^T dO,
    delta = rowsum(dO o o), dS = P o (dO V^T - delta), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    p = _probs(q, k, window)
    qf = q.float().reshape(B, S, K, G, D)
    dof = do.float().reshape(B, S, K, G, D)
    delta = (dof * o.float().reshape(B, S, K, G, D)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) / math.sqrt(D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) / math.sqrt(D)
    return dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_errors(got, want) -> tuple[float, float, float]:
    """Over (dq, dk, dv) ``got`` against ``want``: (max abs err, that over
    the largest |want| of the three, max row error with the floor of
    ``BWD_ROW_FLOOR``).  The scales are the three gradients' together: at
    S = 1 the exact dq and dk are 0 (one visible key: P = 1, dS = 0)."""
    diffs = [x.float() - ref.float() for x, ref in zip(got, want)]
    rows = [ref.float().norm(dim=-1) for ref in want]
    scale = max(float(ref.float().abs().max()) for ref in want)
    floor = BWD_ROW_FLOOR * float(torch.cat([r.flatten() for r in rows]).square().mean().sqrt())
    abs_err = max(float(d.abs().max()) for d in diffs)
    row = max(float((d.norm(dim=-1) / (r + floor)).max()) for d, r in zip(diffs, rows))
    return abs_err, abs_err / max(scale, 1e-30), row
