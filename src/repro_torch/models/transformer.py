"""Model assembly for the dense attention family: init, forward (the
training path, with a rematerialized block loop and the chunked LM-head
cross-entropy), prefill and single-token decode.

Parameters are a dict of tensors with the reference's pytree layout:
per-layer parameters are *stacked* along a leading layer axis under
``blocks``, and every weight keeps the reference's (in, out) orientation
(``x @ w``), so carrying weights across (:func:`repro_torch.convert.lm_params`)
is a copy.  The layer loop is a Python loop over the stacks unbound into
per-layer views (the reference's ``lax.scan``); ``torch.unbind``'s gradient
stacks the layers' gradients once.

Ported: ``block_pattern == "attn"`` without experts, with RoPE positions.
The other families (MoE, Mamba2/zamba2, xLSTM, M-RoPE, codebooks, vision)
raise ``NotImplementedError`` naming ROADMAP.md, Queue 1 item 11.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention,
    attn_init,
    decode_attention,
    init_kv_cache,
)
from repro_torch.models.common import dense_init, mlp_apply, mlp_init, rmsnorm

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
    ported family (dense attention stack with RoPE)."""
    if cfg.block_pattern != "attn":
        raise _not_ported(f"block_pattern={cfg.block_pattern!r}")
    for what, present in (
        ("MoE (n_experts > 0)", cfg.is_moe),
        (f"pos_embed={cfg.pos_embed!r}", cfg.pos_embed != "rope"),
        ("codebook heads (n_codebooks > 0)", cfg.n_codebooks),
        ("vision tokens (n_vision_tokens > 0)", cfg.n_vision_tokens),
    ):
        if present:
            raise _not_ported(what)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _attn_block_init(generator, cfg, dtype):
    dev = generator.device
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attn_init(generator, cfg, dtype),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
    }


def _attn_block_apply(p, x, cfg, positions):
    """Pre-norm attention block. Returns (x, aux, kv); aux is 0.0 for the
    dense family (no MoE balance loss)."""
    h, kv = attention(p["attn"], rmsnorm(x, p["attn_norm"], cfg.norm_eps), cfg, positions)
    x = x + h
    hn = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], hn, cfg.mlp_type), 0.0, kv


def _attn_block_decode(p, x, cfg, cache, pos: int):
    h, cache = decode_attention(
        p["attn"], rmsnorm(x, p["attn_norm"], cfg.norm_eps), cfg, cache, pos
    )
    x = x + h
    hn = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], hn, cfg.mlp_type), cache


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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
def init_params(generator: torch.Generator, cfg) -> dict:
    """Seeded random parameters on ``generator``'s device, in ``cfg.dtype``.

    The draws differ from the reference's (a torch Generator is not a JAX
    key); tests carry the reference's parameters across instead."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    params: dict[str, Any] = {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model), dtype),
        "blocks": _stack([_attn_block_init(generator, cfg, dtype) for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
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
    mlp = {"w_up": (L, d, f), "w_down": (L, f, d)}
    if cfg.mlp_type == "swiglu":
        mlp["w_gate"] = (L, d, f)
    shapes: dict[str, Any] = {
        "embed": (V, d),
        "blocks": {"attn_norm": (L, d), "attn": attn, "mlp_norm": (L, d), "mlp": mlp},
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
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
    return params["embed"][batch["tokens"]]


def _positions(batch, cfg):
    """Position ids (B, S) for RoPE."""
    B, S = batch["tokens"].shape[:2]
    pos = torch.arange(S, dtype=torch.long, device=batch["tokens"].device)
    return pos[None].expand(B, S)


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# forward (training path): layer loop, remat per block
# ---------------------------------------------------------------------------
def _block_x(p, x, cfg, positions):
    return _attn_block_apply(p, x, cfg, positions)[0]


def forward(params, batch, cfg, *, remat: bool = True):
    """Run the stack; returns (hidden (B, S, d), aux_loss 0.0).

    With ``remat`` and grad mode on, each block runs under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    reference's ``jax.checkpoint`` per block: only the block's input is
    kept, and its forward (flash kernel included) runs again in the
    backward."""
    check_supported(cfg)
    x = _embed(params, batch, cfg)
    positions = _positions(batch, cfg)
    rematted = remat and torch.is_grad_enabled()
    for p in _unstack(params["blocks"], cfg.n_layers):
        if rematted:
            x = checkpoint(_block_x, p, x, cfg, positions, use_reentrant=False)
        else:
            x = _block_x(p, x, cfg, positions)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), 0.0


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
    """Scalar training loss: CE + AUX_LOSS_COEF * aux (aux is 0 for the
    dense family)."""
    hidden, aux = forward(params, batch, cfg, remat=remat)
    ce = chunked_ce_loss(hidden, _head_weight(params, cfg), batch["labels"])
    return ce + AUX_LOSS_COEF * aux


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

    token: (B, 1) int; pos: number of tokens already in the state.
    Returns (logits (B, V), state); the state's caches are updated in
    place and returned.
    """
    check_supported(cfg)
    x = _embed(params, {"tokens": token}, cfg)
    for i, p in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        cache = {"k": state["k"][i], "v": state["v"][i]}  # views: written in place
        x, _ = _attn_block_decode(p, x, cfg, cache, pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head_weight(params, cfg))[:, 0], state


def prefill(params, batch, cfg, max_len: int | None = None):
    """Process a full prompt; returns (last-position logits (B, V), decode
    state)."""
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
    return x[:, -1] @ _head_weight(params, cfg), state
