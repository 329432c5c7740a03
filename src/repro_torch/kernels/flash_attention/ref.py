"""Plain PyTorch versions of the flash-attention kernels: materialized
causal (optionally sliding-window) GQA attention in float32, as the
reference's oracle ``repro.kernels.flash_attention.ref.flash_ref`` computes
it, its per-row log-sum-exp (:func:`flash_lse`, the forward kernels' second
output), and its gradient (:func:`flash_bwd_ref`), the backward kernels'
plain version, with the measure a backward is held to
(:func:`flash_bwd_errors`).

The LSE convention, kernels and plain version alike: the natural log of the
sum of exp of the scaled scores q . k / sqrt(D) over the visible keys, in
float32, (B, H, S).  The wgmma forward keeps its running max in log2 units
and converts on the way out; the wgmma backward converts back to log2 units
in its delta pass."""

from __future__ import annotations

import math

import torch

__all__ = ["flash_ref", "flash_lse", "flash_bwd_ref", "flash_bwd_errors", "BWD_TOL",
           "BWD_ROW_REL", "BWD_ROW_FLOOR", "LSE_TOL"]

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
# A forward kernel's LSE against flash_lse, absolute (the LSE of unit-normal
# inputs is O(1-10)): the kernels' f32 scores differ from the plain einsum's
# by summation order (~1e-6), and the wgmma kernel's log2-unit round trip
# and ex2.approx add a few ulp.  A dropped key of n moves it by ~1/n.
LSE_TOL = 1e-4


def flash_ref(q, k, v, *, window=None):
    """q (B, S, H, D); k/v (B, S, K, D) with H = K * G. Returns (B, S, H, D).

    Causal mask; optional sliding window (positions within [i-window+1, i]).
    Computed in f32, returned in q.dtype.
    """
    B, S, H, D = q.shape
    p = torch.softmax(_scores(q, k, window), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def flash_lse(q, k, *, window=None):
    """Per-row log-sum-exp of the scaled, masked scores: (B, H, S) float32,
    natural log, query head h = k * G + g as in :func:`flash_ref`."""
    B, S, H, _ = q.shape
    return torch.logsumexp(_scores(q, k, window), dim=-1).reshape(B, H, S)


def _scores(q, k, window):
    """Scaled scores (B, K, G, S, S) in f32, -inf where the causal (and
    window) mask hides a key."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return s.masked_fill(~mask, -math.inf)


def flash_bwd_ref(q, k, v, o, do, *, window=None):
    """Gradient of :func:`flash_ref` at (q, k, v) for the output gradient
    ``do``, given the forward's output ``o``.  q, o, do (B, S, H, D); k/v
    (B, S, K, D).  Returns (dq, dk, dv) in the inputs' dtypes.  It takes no
    LSE: P is the softmax of the scores, recomputed here.

    The materialized f32 formulas the backward kernels compute tile by tile:
    P = softmax(q k^T / sqrt(D)) under the mask, dV = P^T dO,
    delta = rowsum(dO o o), dS = P o (dO V^T - delta), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    p = torch.softmax(_scores(q, k, window), dim=-1)
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
