"""Model assembly for the attention family: init, forward (the training
path, with a rematerialized block loop and the chunked LM-head
cross-entropy), prefill and single-token decode.

Parameters are a dict of tensors with the reference's pytree layout:
per-layer parameters are *stacked* along a leading layer axis under
``blocks``, and every weight keeps the reference's (in, out) orientation
(``x @ w``), so carrying weights across (:func:`repro_torch.convert.lm_params`)
is a copy.  The layer loop is a Python loop over the stacks unbound into
per-layer views (the reference's ``lax.scan``); ``torch.unbind``'s gradient
stacks the layers' gradients once.

Ported: ``block_pattern == "attn"``, with a dense MLP or a mixture of
experts (:mod:`repro_torch.models.moe`, whose auxiliary loss the forward
sums over the layers), with RoPE, M-RoPE (the VLM stub: ``vision_embeds``
over the first ``n_vision_tokens`` positions, laid out on a (t, h, w)
grid) or sinusoidal positions, and with one token stream or
``n_codebooks`` of them (summed embeddings, one head a codebook, the CE
averaged over codebooks).  The recurrent block patterns (Mamba2/zamba2,
xLSTM) raise ``NotImplementedError`` naming ROADMAP.md, Queue 1 item 11.

Inputs are dicts: ``tokens`` (B, S) integer (codebooks: (B, S, n_cb)),
``labels`` shaped like the tokens with -1 masking a position, and for the
VLM ``vision_embeds`` (B, n_vision_tokens, d_model).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention,
    decode_attention,
    init_kv_cache,
)
from repro_torch.models.common import (
    dense_init,
    mlp_apply,
    rmsnorm,
    sinusoidal_positions,
)
from repro_torch.models.moe import DRAWN as MOE_DRAWN
from repro_torch.models.moe import moe_apply, moe_shapes

__all__ = [
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_decode_state",
    "chunked_ce_loss",
    "param_count",
    "param_dtype",
    "param_shapes",
    "AUX_LOSS_COEF",
    "LOSS_CHUNK",
]

AUX_LOSS_COEF = 0.01
LOSS_CHUNK = 2048  # sequence chunk of the LM-head cross-entropy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def param_dtype(cfg) -> torch.dtype:
    """The torch dtype that ``cfg.dtype`` names."""
    return _DTYPES[cfg.dtype]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md, Queue 1 item 11"
    )


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration outside the
    ported families (the attention stack, dense or with experts)."""
    if cfg.block_pattern != "attn":
        raise _not_ported(f"block_pattern={cfg.block_pattern!r}")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _ffn(p, hn, cfg):
    """The block's MLP or its mixture of experts: (out, aux), aux 0.0 for a
    dense MLP (no balance loss)."""
    if cfg.is_moe:
        return moe_apply(p["moe"], hn, cfg)
    return mlp_apply(p["mlp"], hn, cfg.mlp_type), 0.0


def _attn_block_apply(p, x, cfg, positions):
    """Pre-norm attention block. Returns (x, aux, kv)."""
    h, kv = attention(p["attn"], rmsnorm(x, p["attn_norm"], cfg.norm_eps), cfg, positions)
    x = x + h
    m, aux = _ffn(p, rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg)
    return x + m, aux, kv


def _attn_block_decode(p, x, cfg, cache, pos: int):
    # M-RoPE: text tokens past the vision prefix sit at t = h = w = pos - nv + g
    rope_pos = pos - cfg.n_vision_tokens + _grid(cfg) if cfg.pos_embed == "mrope" else None
    h, cache = decode_attention(
        p["attn"], rmsnorm(x, p["attn_norm"], cfg.norm_eps), cfg, cache, pos, rope_pos
    )
    x = x + h
    m, _ = _ffn(p, rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg)
    return x + m, cache


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(blocks, n: int) -> list:
    """Every layer's parameters, as views: one ``torch.unbind`` a stack, so
    that the gradient of the stack is one ``torch.stack`` of the layers'
    gradients (indexing a stack once a layer would give each layer's
    gradient a zero-filled copy of the whole stack)."""
    def walk(tree, i):
        if isinstance(tree, dict):
            return {k: walk(v, i) for k, v in tree.items()}
        return tree[i]

    unbound = _tree_map(torch.unbind, blocks)
    return [walk(unbound, i) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
# The stacked leaves drawn from the generator, in the order of one layer's
# draws (the attention's, then the MLP's or the experts'); the others are
# ones (norms) or zeros (biases).
_DRAWN = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
          ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"),
          *(("moe", name) for name in MOE_DRAWN))


def init_params(generator: torch.Generator, cfg) -> dict:
    """Seeded random parameters on ``generator``'s device, in ``cfg.dtype``.

    Each stacked leaf is allocated once, (L,) + shape, and layer i's draw
    goes into its slice, layer by layer in ``_DRAWN``'s order; so the
    weights are never held twice, and the largest transient is one leaf's
    float32 draw.  The draws differ from the reference's (a torch Generator
    is not a JAX key); tests carry the reference's parameters across
    instead."""
    check_supported(cfg)
    dtype, dev = param_dtype(cfg), generator.device
    shapes = param_shapes(cfg)
    params: dict[str, Any] = {"embed": dense_init(generator, shapes["embed"], dtype)}
    blocks = _tree_map(lambda shape: torch.empty(shape, dtype=dtype, device=dev),
                       shapes["blocks"])
    for name in ("attn_norm", "mlp_norm"):
        blocks[name].fill_(1)
    for name, leaf in blocks["attn"].items():
        if name in ("bq", "bk", "bv"):
            leaf.zero_()
        elif name in ("q_norm", "k_norm"):
            leaf.fill_(1)
    drawn = [blocks[group][name] for group, name in _DRAWN
             if group in blocks and name in blocks[group]]
    for i in range(cfg.n_layers):
        for leaf in drawn:
            leaf[i].copy_(dense_init(generator, leaf.shape[1:], dtype))
    params["blocks"] = blocks
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if "lm_head" in shapes:
        params["lm_head"] = dense_init(generator, shapes["lm_head"], dtype)
    return params


def param_shapes(cfg) -> dict:
    """The shape of every parameter, in the layout of :func:`init_params`
    (and of the reference's ``init_params`` pytree)."""
    check_supported(cfg)
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn = {"wq": (L, d, H * hd), "wk": (L, d, K * hd), "wv": (L, d, K * hd),
            "wo": (L, H * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(L, H * hd), bk=(L, K * hd), bv=(L, K * hd))
    if cfg.qk_norm:
        attn.update(q_norm=(L, hd), k_norm=(L, hd))
    blocks: dict[str, Any] = {"attn_norm": (L, d), "attn": attn, "mlp_norm": (L, d)}
    if cfg.is_moe:
        blocks["moe"] = {name: (L,) + sh for name, sh in moe_shapes(cfg).items()}
    else:
        mlp = {"w_gate": (L, d, f)} if cfg.mlp_type == "swiglu" else {}
        mlp.update(w_up=(L, d, f), w_down=(L, f, d))
        blocks["mlp"] = mlp
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    shapes: dict[str, Any] = {"embed": cb + (V, d), "blocks": blocks, "final_norm": (d,)}
    if cfg.n_codebooks or not cfg.tie_embeddings:
        shapes["lm_head"] = cb + (d, V)
    return shapes


def param_count(params) -> int:
    return sum(a.numel() for a in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# embedding / positions / head
# ---------------------------------------------------------------------------
def _embed(params, batch, cfg):
    """Token embeddings (codebooks: their sum), the vision embeddings over
    the first ``n_vision_tokens`` positions, and sinusoidal positions."""
    tokens = batch["tokens"]
    if cfg.n_codebooks:
        x = params["embed"][0][tokens[..., 0]]
        for c in range(1, cfg.n_codebooks):
            x = x + params["embed"][c][tokens[..., c]]
    else:
        x = params["embed"][tokens]
    S = tokens.shape[1]
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        nv = cfg.n_vision_tokens
        if S < nv:
            raise ValueError(f"{S} positions cannot hold the {nv} vision tokens")
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x[:, nv:]], dim=1)
    if cfg.pos_embed == "sinusoidal":
        pos = torch.arange(S, device=x.device)[None]
        x = x + sinusoidal_positions(pos, cfg.d_model, x.dtype)
    return x


def _grid(cfg) -> int:
    """Side of the VLM stub's square patch grid: isqrt(n_vision_tokens)."""
    return max(math.isqrt(max(cfg.n_vision_tokens, 1)), 1)


def _positions(batch, cfg):
    """Position ids: (B, S) for RoPE, (3, B, S) t/h/w for M-RoPE.

    M-RoPE (the VLM stub): the first ``n_vision_tokens`` positions form a
    g x g patch grid at t = 0; text tokens advance all three coordinates
    together from the grid's extent g (Qwen2-VL's convention)."""
    B, S = batch["tokens"].shape[:2]
    i = torch.arange(S, dtype=torch.long, device=batch["tokens"].device)
    if cfg.pos_embed != "mrope":
        return i[None].expand(B, S)
    nv, g = cfg.n_vision_tokens, _grid(cfg)
    is_vis = i < nv
    text = i - nv + g
    t = torch.where(is_vis, 0, text)
    h = torch.where(is_vis, i // g, text)
    w = torch.where(is_vis, i % g, text)
    return torch.stack([t, h, w])[:, None, :].expand(3, B, S)


def _head_weight(params, cfg):
    """(d, V), or (n_cb, d, V) with codebooks."""
    if cfg.tie_embeddings and not cfg.n_codebooks:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# forward (training path): layer loop, remat per block
# ---------------------------------------------------------------------------
def _block_x(p, x, cfg, positions):
    """(x, aux) of one block: under remat, aux is recomputed and
    differentiated with the block."""
    x, aux, _ = _attn_block_apply(p, x, cfg, positions)
    return x, aux


def forward(params, batch, cfg, *, remat: bool = True):
    """Run the stack; returns (hidden (B, S, d), aux_loss): the MoE
    balance losses summed over the layers in f32 (0.0 without experts),
    as the reference's scan carry sums them.

    With ``remat`` and grad mode on, each block runs under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    reference's ``jax.checkpoint`` per block: only the block's input is
    kept, and its forward (flash kernel included) runs again in the
    backward."""
    check_supported(cfg)
    x = _embed(params, batch, cfg)
    positions = _positions(batch, cfg)
    rematted = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if cfg.is_moe else 0.0
    for p in _unstack(params["blocks"], cfg.n_layers):
        if rematted:
            x, a = checkpoint(_block_x, p, x, cfg, positions, use_reentrant=False)
        else:
            x, a = _block_x(p, x, cfg, positions)
        aux = aux + a
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# LM head + cross-entropy, chunked over the sequence
# ---------------------------------------------------------------------------
def _ce_chunk(hc, head_w, lc):
    """Summed CE of one chunk over its valid (label >= 0) positions; the
    (B, c, V) logits in f32, as the reference."""
    logits = (hc @ head_w).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), lc.reshape(-1).long(),
                           ignore_index=-1, reduction="sum")


def chunked_ce_loss(hidden, head_w, labels, chunk: int = LOSS_CHUNK):
    """Mean next-token CE over valid (label >= 0) positions.

    hidden (B, S, d); head_w (d, V); labels (B, S) already shifted by the
    data pipeline (-1 = ignore).  Loops over S-chunks, each chunk's body
    under checkpoint when grad mode is on, so the (B, c, V) float32 logits
    exist only transiently in the forward and in the backward (saving
    every chunk's logits would keep the whole (B, S, V) f32 tensor the
    function exists to avoid)."""
    B, S, d = hidden.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"chunked_ce_loss: sequence {S} is not a multiple of the chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        hc, lc = hidden[:, i:i + c], labels[:, i:i + c]
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_ce_chunk, hc, head_w, lc, use_reentrant=False)
        else:
            tot = tot + _ce_chunk(hc, head_w, lc)
    cnt = (labels >= 0).sum()
    return tot / torch.clamp(cnt, min=1)


def loss_fn(params, batch, cfg, *, remat: bool = True):
    """Scalar training loss: CE (averaged over codebooks) + AUX_LOSS_COEF *
    aux (aux is 0 without experts)."""
    hidden, aux = forward(params, batch, cfg, remat=remat)
    w = _head_weight(params, cfg)
    if cfg.n_codebooks:
        ce = 0.0
        for cb in range(cfg.n_codebooks):
            ce = ce + chunked_ce_loss(hidden, w[cb], batch["labels"][..., cb])
        ce = ce / cfg.n_codebooks
    else:
        ce = chunked_ce_loss(hidden, w, batch["labels"])
    return ce + AUX_LOSS_COEF * aux


def _logits(x, w):
    """The head on x (B, d) or (B, 1, d): (B, V), or (B, n_cb, V) with
    codebooks' heads w (n_cb, d, V)."""
    if x.ndim == 3:
        x = x[:, 0]
    if w.ndim == 3:
        return torch.einsum("bd,cdv->bcv", x, w)
    return x @ w


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with explicit state
# ---------------------------------------------------------------------------
def init_decode_state(cfg, batch: int, max_len: int, device=None):
    """KV cache of every layer, stacked: k/v (L, B, size, K, hd)."""
    check_supported(cfg)
    one = init_kv_cache(cfg, batch, max_len, param_dtype(cfg), device)
    return {
        name: torch.zeros((cfg.n_layers,) + a.shape, dtype=a.dtype, device=a.device)
        for name, a in one.items()
    }


def decode_step(params, token, state, pos: int, cfg):
    """One decode step.

    token: (B, 1) int (codebooks: (B, 1, n_cb)); pos: number of tokens
    already in the state.  Returns (logits (B, V) (codebooks: (B, n_cb,
    V)), state); the state's caches are updated in place and returned.
    """
    check_supported(cfg)
    x = _embed(params, {"tokens": token}, cfg)
    if cfg.pos_embed == "sinusoidal":
        # _embed added position 0's embedding; put pos's in its place
        dev = x.device
        x = x - sinusoidal_positions(torch.zeros((1, 1), dtype=torch.long, device=dev),
                                     cfg.d_model, x.dtype)
        x = x + sinusoidal_positions(torch.full((1, 1), pos, dtype=torch.long, device=dev),
                                     cfg.d_model, x.dtype)
    for i, p in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        cache = {"k": state["k"][i], "v": state["v"][i]}  # views: written in place
        x, _ = _attn_block_decode(p, x, cfg, cache, pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, _head_weight(params, cfg)), state


def prefill(params, batch, cfg, max_len: int | None = None):
    """Process a full prompt; returns (last-position logits (B, V), or
    (B, n_cb, V) with codebooks, and the decode state)."""
    check_supported(cfg)
    B, S = batch["tokens"].shape[:2]
    max_len = max_len or S
    x = _embed(params, batch, cfg)
    positions = _positions(batch, cfg)
    state = init_decode_state(cfg, B, max_len, x.device)
    size = state["k"].shape[2]
    if S > size and not cfg.sliding_window:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of max_len={max_len}")
    if cfg.sliding_window and S > size:
        # rolling window layout: position t of the last `size` lands in
        # slot t % size
        slots = torch.arange(S - size, S, device=x.device) % size
    for i, p in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        x, _, (k, v) = _attn_block_apply(p, x, cfg, positions)
        # In place: each layer's k/v go straight into the preallocated
        # (L, B, size, K, hd) cache; the reference stacks every layer's k/v
        # and then copies the stack into its cache.
        for name, t in (("k", k), ("v", v)):
            if cfg.sliding_window and S > size:
                state[name][i][:, slots] = t[:, S - size:].to(state[name].dtype)
            else:
                state[name][i, :, :S] = t.to(state[name].dtype)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x[:, -1], _head_weight(params, cfg)), state
