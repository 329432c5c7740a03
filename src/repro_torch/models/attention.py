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
  order (under sequence parallelism the normed input is all-gathered
  along the sequence and the partial outputs reduce-scattered along it).
  Otherwise every device gathers the weights whole and computes the block
  replicated.
* :func:`mesh_prefill_cache` and :func:`mesh_decode_attention` -- the KV
  cache on a mesh, laid out by ``decode_state_pspecs``: its sequence axis
  split over ``model`` (or, where that does not divide, another axis, or
  none).  Prefill sends each block of positions' k/v to the model device
  that owns it (an all-to-all when the heads are split over ``model``).
  Decode writes the new token's k/v on the owner of its slot; each model
  device scores the query against its own block of positions, a partial
  softmax (max, sum, weighted values, all f32), and the partials,
  stacked in model order, are combined by log-sum-exp (a fixed-order sum
  over the stack) on each device that applies the heads' output (under
  tensor parallelism each its own heads, after an all-to-all; else every
  head, after an all-gather): no atomics, and bitwise repeatable.  A cache whose sequence is not split is gathered
  whole on each device (a view where nothing is split: on a model axis
  of 1 the unsharded :func:`decode_attention`, op for op).

KV heads stay folded (B, S, K, hd) with queries grouped (K, G): query head
h = k * G + g.  Positions rotate q and k by RoPE ((B, S) positions) or
M-RoPE ((3, B, S)); sinusoidal positions are added at the embedding and
leave q and k alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.collectives import gather_blocks
from repro_torch.distributed.sharding import (
    dp_axes,
    local_tree_views,
    local_views,
    mesh_all_gather,
    mesh_all_reduce,
    mesh_all_to_all,
    mesh_block,
    mesh_reduce_scatter,
    own_part,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import rmsnorm
from repro_torch.models.rope import apply_mrope, apply_rope

__all__ = ["attention", "mesh_attention", "attention_tp", "decode_attention", "init_kv_cache",
           "fill_cache", "mesh_prefill_cache", "mesh_decode_attention"]

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


def _local_cfg(cfg, mesh, tp: bool):
    """``cfg`` with a model device's share of the heads under tensor
    parallelism."""
    if not tp:
        return cfg
    M = mesh.shape["model"]
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // M, n_kv_heads=cfg.n_kv_heads // M,
                               head_dim=cfg.head_dim_)


def mesh_attention(params, xs, cfg, mesh, positions, seq_parallel: bool = False):
    """Full-sequence causal attention of one block on ``mesh``: params the
    block's attention leaves (``Sharded``), xs and positions one entry a
    mesh device (its data row's rows).  Returns each device's output,
    (B_row, S, d_model), equal over a data row's model devices, and its
    (k, v), (B_row, S, K_local, hd): its own kv heads under tensor
    parallelism (:func:`attention_tp`), every head otherwise.

    ``seq_parallel`` (Megatron-SP): each x is the device's block of
    positions (B_row, S / M, d_model), all-gathered over ``model`` along
    the sequence first; the output is the device's block of positions,
    the partial outputs of tensor parallelism reduce-scattered along the
    sequence (else its block of the replicated output)."""
    tp = attention_tp(params, cfg, mesh)
    views = local_tree_views(params, ("model",) if tp else ())
    lcfg = _local_cfg(cfg, mesh, tp)
    if seq_parallel:
        xs = mesh_all_gather(xs, mesh, 1)
    outs = [attention(v, x, lcfg, pos) for v, x, pos in zip(views, xs, positions)]
    hs = [h for h, _ in outs]
    kvs = [kv for _, kv in outs]
    if seq_parallel:
        return (mesh_reduce_scatter(hs, mesh, 1) if tp
                else [mesh_block(h, mesh, kd, 1) for kd, h in enumerate(hs)]), kvs
    return (mesh_all_reduce(hs, mesh) if tp else hs), kvs


def _seq_split(cache_sh, mesh) -> bool:
    """Whether a cache layer's (B, size, K, hd) layout splits its
    positions over a model axis of more than one device."""
    return mesh.shape.get("model", 1) > 1 and "model" in cache_sh.parts()[1]


def fill_cache(cache, t, cfg) -> None:
    """Write a prompt's k or v, t (B, S, K, hd), into one layer's cache
    (B, size, K, hd), in place: its first S slots, or under SWA with S >
    size the rolling window's (position t of the last ``size`` lands in
    slot t % size)."""
    S, size = t.shape[1], cache.shape[1]
    if cfg.sliding_window and S > size:
        slots = torch.arange(S - size, S, device=t.device) % size
        cache[:, slots] = t[:, S - size:].to(cache.dtype)
    else:
        cache[:, :S] = t.to(cache.dtype)


def mesh_prefill_cache(cache: dict, kvs: list, cfg, mesh, tp: bool) -> None:
    """Write one layer's prompt k/v into its cache on ``mesh``, in place.
    cache: ``{"k", "v"}`` :class:`Sharded` (B, size, K, hd) layers; kvs:
    each device's (k, v) from :func:`mesh_attention` (``tp``: its own kv
    heads).  Each device first lays its k/v out as the unsharded prefill
    does (the first S slots, or a rolling window's slots), then keeps its
    block: under tensor parallelism a sequence-split cache takes its
    positions' k/v of every head by an all-to-all, a head-split one its own
    heads; otherwise the heads are gathered first."""
    keep = dp_axes(mesh)
    for j, name in enumerate(("k", "v")):
        sh = cache[name]
        size = sh.shape[1]
        fills = []
        for kv in kvs:
            t = kv[j]
            fill = t.new_zeros((t.shape[0], size) + tuple(t.shape[2:]), dtype=sh.dtype)
            fill_cache(fill, t, cfg)
            fills.append(fill)
        heads_split = "model" in sh.parts()[2]
        if tp and _seq_split(sh, mesh):
            blocks = mesh_all_to_all(fills, mesh, split_dim=1, concat_dim=2)
        elif tp and heads_split:
            blocks = [own_part(sh, kd, f, keep + ("model",)) for kd, f in enumerate(fills)]
        else:
            if tp:
                fills = mesh_all_gather(fills, mesh, 2)
            blocks = [own_part(sh, kd, f, keep) for kd, f in enumerate(fills)]
        for b, new in zip(sh.blocks, blocks):
            b.copy_(new)


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
    q, k_new, v_new = _qkv(params, x, cfg, _decode_positions(x, cfg, pos, rope_pos))

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


def _decode_positions(x, cfg, pos: int, rope_pos: int | None):
    B = x.shape[0]
    positions = torch.full((B, 1), pos if rope_pos is None else rope_pos, dtype=torch.long,
                           device=x.device)
    return positions.expand(3, B, 1) if cfg.pos_embed == "mrope" else positions


def mesh_decode_attention(params, xs, cfg, mesh, cache: dict, pos: int,
                          rope_pos: int | None = None) -> list:
    """:func:`decode_attention` of one block on ``mesh``: params the
    block's attention leaves (``Sharded``), xs each device's (B_row, 1, d)
    rows, cache ``{"k", "v"}`` :class:`Sharded` (B, size, K, hd) layers
    (written in place).  Returns each device's output (B_row, 1, d)."""
    if not _seq_split(cache["k"], mesh):
        return _gathered_decode(params, xs, cfg, mesh, cache, pos, rope_pos)
    tp = attention_tp(params, cfg, mesh)
    views = local_tree_views(params, ("model",) if tp else ())
    lcfg = _local_cfg(cfg, mesh, tp)
    qkv = [_qkv(v, x, lcfg, _decode_positions(x, cfg, pos, rope_pos))
           for v, x in zip(views, xs)]
    qs = [q for q, _, _ in qkv]
    if tp:
        qs = mesh_all_gather(qs, mesh, 2)  # every head's query on each model device
    kc, vc = cache["k"], cache["v"]
    size = kc.shape[1]
    C = size // mesh.shape["model"]
    slot = pos % size if cfg.sliding_window else pos
    owner = slot // C
    # the new token's k/v (every head) on the device that owns the slot
    for j, sh in ((1, kc), (2, vc)):
        for kd in range(mesh.size):
            if mesh.coords(kd)["model"] != owner:
                continue
            new = qkv[kd][j]
            if tp:
                group = mesh.group(kd, ("model",))
                parts = [qkv[g][j] for g in group]
                kl = parts[0].shape[2]
                new = gather_blocks(parts, [(0, 0, i * kl, 0) for i in range(len(group))],
                                    (new.shape[0], 1, kl * len(group), new.shape[3]),
                                    [mesh.flat[kd]])[0]
            sh.blocks[kd][:, slot - owner * C] = new[:, 0].to(sh.dtype)
    K, hd = cfg.n_kv_heads, cfg.head_dim_
    G = cfg.n_heads // K
    packs = []
    for kd, q in enumerate(qs):
        m = mesh.coords(kd)["model"]
        kb, vb = kc.blocks[kd], vc.blocks[kd]
        B = q.shape[0]
        s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, 1, K, G, hd), kb) / math.sqrt(hd)
        idx = torch.arange(m * C, (m + 1) * C, device=q.device)
        valid = idx <= slot if not cfg.sliding_window else (idx <= slot) | (pos >= size)
        s = torch.where(valid, s.float(), NEG_INF)
        mx = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - mx)
        acc = torch.einsum("bkgqs,bskd->bkgqd", e, vb.float())
        packs.append(torch.cat([mx, e.sum(dim=-1, keepdim=True), acc], dim=-1)[None])
    # (M, B, K_local, G, 1, hd + 2): every model device's partial (max, sum,
    # weighted values) of the heads used here; o is (B, K_local, G, 1, hd)
    parts = (mesh_all_to_all(packs, mesh, split_dim=2, concat_dim=0) if tp
             else mesh_all_gather(packs, mesh, 0))
    hs = []
    for v, x, part in zip(views, xs, parts):
        # log-sum-exp over the model axis, a fixed-order reduction
        mx = part[..., :1]
        w = torch.exp(mx - mx.amax(dim=0))
        o = ((w * part[..., 2:]).sum(dim=0) / (w * part[..., 1:2]).sum(dim=0)).to(x.dtype)
        hs.append(o.permute(0, 3, 1, 2, 4).reshape(x.shape[0], 1, -1) @ v["wo"])
    return mesh_all_reduce(hs, mesh) if tp else hs


def _gathered_decode(params, xs, cfg, mesh, cache, pos, rope_pos) -> list:
    """Decode attention with each device's rows of the cache gathered over
    ``model`` (a view of its block where the layout splits nothing but
    rows) and every head computed replicated; the device's block is then
    cut back out of its updated copy."""
    keep = dp_axes(mesh)
    views = local_tree_views(params)
    ks, vs = (local_views(cache[n], keep) for n in ("k", "v"))
    hs = []
    for kd, (v, x) in enumerate(zip(views, xs)):
        local = {"k": ks[kd], "v": vs[kd]}
        h, _ = decode_attention(v, x, cfg, local, pos, rope_pos)
        hs.append(h)
        for n in ("k", "v"):
            if local[n] is not cache[n].blocks[kd]:
                cache[n].blocks[kd].copy_(own_part(cache[n], kd, local[n], keep))
    return hs
