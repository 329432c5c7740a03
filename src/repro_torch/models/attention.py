"""Attention: GQA with optional QKV bias, qk-norm and sliding window.

Two paths, as in the reference:

* :func:`attention` -- full-sequence causal attention.  The score /
  softmax / PV step goes through :func:`repro_torch.kernels.flash_attention.flash_attention`:
  on the card that is the hand-written kernel (online softmax over KV
  tiles, no S x S intermediate), on the CPU its plain version.  There is
  one path for every S; the reference's ``impl`` switch chooses between
  two XLA strategies (``full`` materialized, ``chunked`` online softmax)
  for the same function, and the tests hold this one against both.  In
  training it is differentiable: its gradient is the flash backward
  kernel (``FlashAttention``), where the reference takes XLA's autodiff
  of those strategies.
* :func:`decode_attention` -- a one-token query against a KV cache (dense,
  or a rolling sliding-window buffer), in plain PyTorch: the reference has
  no kernel for it either.
* :func:`mesh_attention` -- :func:`attention` on an
  :class:`~repro_torch.distributed.sharding.LMMesh`, Megatron-style over
  its ``model`` axis where the heads divide it: each model device runs
  its own query and kv heads (its column blocks of ``wq``/``wk``/``wv``,
  and of ``bq``/``bk``/``bv``) through the same flash route and applies
  its row block of ``wo``; the partial outputs are all-reduced in model
  order.  Otherwise every device gathers the weights whole and computes
  the block replicated.

KV heads stay folded (B, S, K, hd) with queries grouped (K, G): query head
h = k * G + g.  Positions rotate q and k by RoPE ((B, S) positions) or
M-RoPE ((3, B, S)); sinusoidal positions are added at the embedding and
leave q and k alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import local_tree_views, mesh_all_reduce
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import rmsnorm
from repro_torch.models.rope import apply_mrope, apply_rope

__all__ = ["attention", "mesh_attention", "attention_tp", "decode_attention", "init_kv_cache"]

NEG_INF = -1e30


def _qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.pos_embed == "rope":
        pos2 = positions if positions.ndim == 2 else positions[0]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
    return q, k, v


def attention(params, x, cfg, positions):
    """Full-sequence causal attention; returns ((B, S, d_model), (k, v))
    with k/v (B, S, K, hd) for the decode cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    o = flash_attention(q, k, v, window=cfg.sliding_window)
    return o.reshape(B, S, -1) @ params["wo"], (k, v)


def _has_model(sh) -> bool:
    return any("model" in axes for axes in sh.parts())


def attention_tp(params, cfg, mesh) -> bool:
    """Whether the attention runs tensor parallel on ``mesh``: a model axis
    of M > 1 that divides both head counts, over which the layout splits
    every projection (``tp=False`` layouts do not)."""
    M = mesh.shape.get("model", 1)
    return (M > 1 and cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0
            and all(_has_model(params[w]) for w in ("wq", "wk", "wv", "wo")))


def mesh_attention(params, xs, cfg, mesh, positions):
    """Full-sequence causal attention of one block on ``mesh``: params the
    block's attention leaves (``Sharded``), xs and positions one entry a
    mesh device (its data row's rows).  Returns each device's output,
    (B_row, S, d_model); equal over a data row's model devices."""
    tp = attention_tp(params, cfg, mesh)
    views = local_tree_views(params, ("model",) if tp else ())
    if tp:
        M = mesh.shape["model"]
        cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // M,
                                  n_kv_heads=cfg.n_kv_heads // M, head_dim=cfg.head_dim_)
    hs = [attention(v, x, cfg, pos)[0] for v, x, pos in zip(views, xs, positions)]
    return mesh_all_reduce(hs, mesh) if tp else hs


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def init_kv_cache(cfg, batch: int, max_len: int, dtype, device=None):
    """Dense cache, or a rolling window buffer under SWA."""
    K, hd = cfg.n_kv_heads, cfg.head_dim_
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {
        "k": torch.zeros((batch, size, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, K, hd), dtype=dtype, device=device),
    }


def decode_attention(params, x, cfg, cache, pos: int, rope_pos: int | None = None):
    """One-token step: x (B, 1, d); cache k/v (B, C, K, hd); pos the number
    of tokens already in the cache; ``rope_pos`` the rotary position when it
    is not the cache slot's (M-RoPE's text positions are offset by the
    vision grid's extent).

    Returns (out (B, 1, d), cache).  The new k/v are written into
    ``cache`` in place (the reference returns an updated copy).  Under SWA
    the buffer is rolling (slot = pos % size); otherwise slot = pos, and a
    full cache raises an IndexError.
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // K
    positions = torch.full((B, 1), pos if rope_pos is None else rope_pos, dtype=torch.long,
                           device=x.device)
    if cfg.pos_embed == "mrope":
        positions = positions.expand(3, B, 1)
    q, k_new, v_new = _qkv(params, x, cfg, positions)

    size = cache["k"].shape[1]
    slot = pos % size if cfg.sliding_window else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]

    qg = q.reshape(B, 1, K, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
    idx = torch.arange(size, device=x.device)
    valid = idx <= slot if not cfg.sliding_window else (idx <= slot) | (pos >= size)
    s = torch.where(valid, s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(B, 1, H * hd)
    return o @ params["wo"], cache
