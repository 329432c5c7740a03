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
averaged over codebooks).

Also ported: the recurrent stacks of Mamba2 mixers
(:mod:`repro_torch.models.ssm`), ``block_pattern == "mamba2"`` (a plain
stack) and ``"zamba2"`` (groups of ``shared_attn_every`` Mamba2 layers, one
weight-shared attention+MLP block, unstacked under ``shared``, applied
after each group: 9 applications of one set of attention weights at 54
layers).  Under remat each Mamba2 layer is rematerialized inside a
rematerialized group, as in the reference, so a group's attention runs
twice in a train step's forward (the forward and the group's recompute).

And the xLSTM stack (:mod:`repro_torch.models.xlstm`), ``block_pattern ==
"xlstm"``: heterogeneous blocks, so ``blocks`` is a Python *list* of
per-layer dicts, as in the reference: an sLSTM block (its leaves at the
top, its norm after the recurrence, no pre-norm) at each index of
``slstm_indices``, else ``{"norm", "mixer"}``, a pre-norm mLSTM block.
Its decode state is a list too: the sLSTM's (c, n, h, m) tuple or the
mLSTM's dict, a layer.  The reference's forward takes no remat for it;
here each mLSTM block is rematerialized under ``remat`` (the same values;
a full-width step needs it), the sLSTM blocks are not.

On an :class:`~repro_torch.distributed.sharding.LMMesh`,
:func:`mesh_loss_fn` (``loss_fn(..., mesh=)``) runs the same stack as one
program a mesh device, over parameters laid out by ``param_pspecs``
(``Sharded`` leaves): each device takes its data row's rows of the batch;
an attention block runs tensor parallel over ``model`` where the heads
(:func:`~repro_torch.models.attention.mesh_attention`) and ``d_ff`` divide
it, the MoE expert or capacity parallel
(:func:`~repro_torch.models.moe.moe_mesh_apply`); the Mamba2, mLSTM and
sLSTM mixers tensor parallel by heads where their heads divide it and the
layout splits their projections (:func:`_mesh_mamba_block`,
:func:`_mesh_xlstm_block`), else gathered whole.  Each block's gathers run
inside its remat, so the recompute gathers again, as FSDP does.  Without specs the residual
stream is each device's data row's (rows, S, d), replicated over
``model``, and the CE runs on each data row's first model device (on every
device when the batch is split over ``model`` too, the pure-DP layout).
The reference's ``act_spec = act_pspec(axes)`` is computed as Megatron-SP:
each device keeps its (rows, S / M, d) block of positions between blocks
(what remat saves for a block), a tensor-parallel block all-gathers its
normed input along the sequence and reduce-scatters its partial outputs,
any other block runs on the gathered sequence and keeps its block;
``logits_spec = P(dp, None, "model")`` runs the chunked CE vocab parallel
(each device's (rows, c, V / M) logits, the log-sum-exp combined over
``model``).  The rows' CE sums over the global count of valid labels.  On a
(1, 1) mesh it is :func:`loss_fn`, op for op.

:func:`mesh_prefill` and :func:`mesh_decode_step` serve on the same
layout: parameters by ``param_pspecs``, the decode state by
``decode_state_pspecs`` (batch rows over ``data``, a KV cache's positions
over ``model``; see :func:`~repro_torch.models.attention.mesh_decode_attention`),
each device computing its data row's rows; the Mamba2, zamba2 and xLSTM
mixers gathered whole (not tensor parallel as in training: the conv's and
the mLSTM's state layouts are not head-aligned) and their states gathered
over ``model`` for use, each device keeping its block of the new state.
On a (1, 1) mesh they are :func:`prefill` and :func:`decode_step`, op for
op.

Inputs are dicts: ``tokens`` (B, S) integer (codebooks: (B, S, n_cb)),
``labels`` shaped like the tokens with -1 masking a position, and for the
VLM ``vision_embeds`` (B, n_vision_tokens, d_model).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import gather_blocks, ordered_sum, to_device
from repro_torch.distributed.sharding import (
    Sharded,
    decode_state_pspecs,
    dp_axes,
    head_column_views,
    local_tree_views,
    local_views,
    mesh_all_gather,
    mesh_all_reduce,
    mesh_block,
    mesh_reduce_scatter,
    mesh_rmsnorm,
    own_part,
    shard_of,
    sharded_zeros,
)
from repro_torch.models.attention import (
    attention,
    attention_tp,
    decode_attention,
    fill_cache,
    init_kv_cache,
    mesh_attention,
    mesh_decode_attention,
    mesh_prefill_cache,
)
from repro_torch.models.common import (
    dense_init,
    mlp_apply,
    rmsnorm,
    sinusoidal_positions,
)
from repro_torch.models import ssm as _ssm
from repro_torch.models import xlstm as _xl
from repro_torch.models.moe import DRAWN as MOE_DRAWN
from repro_torch.models.moe import moe_apply, moe_mesh_apply, moe_shapes

__all__ = [
    "init_params",
    "forward",
    "loss_fn",
    "mesh_loss_fn",
    "mixer_heads",
    "prefill",
    "decode_step",
    "mesh_prefill",
    "mesh_decode_step",
    "abstract_params",
    "init_decode_state",
    "chunked_ce_loss",
    "param_count",
    "param_dtype",
    "leaf_dtype",
    "param_shapes",
    "attention_layers",
    "check_supported",
    "AUX_LOSS_COEF",
    "LOSS_CHUNK",
]

AUX_LOSS_COEF = 0.01
LOSS_CHUNK = 2048  # sequence chunk of the LM-head cross-entropy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def param_dtype(cfg) -> torch.dtype:
    """The torch dtype that ``cfg.dtype`` names."""
    return _DTYPES[cfg.dtype]


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for an unknown ``block_pattern`` (as the
    reference's ``init_params`` does) and for a zamba2 whose layers do not
    split into its groups."""
    if cfg.block_pattern not in ("attn", "mamba2", "zamba2", "xlstm"):
        raise ValueError(cfg.block_pattern)
    if cfg.block_pattern == "zamba2" and (
            cfg.shared_attn_every < 1 or cfg.n_layers % cfg.shared_attn_every):
        raise ValueError("zamba2 requires n_layers % shared_attn_every == 0")


def attention_layers(cfg) -> int:
    """How many attention blocks a forward applies: every layer of the
    attention stack, one a group of zamba2 (the shared block), none in a
    Mamba2 or xLSTM stack."""
    if cfg.block_pattern == "zamba2":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers if cfg.block_pattern == "attn" else 0


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


def _rope_pos(pos: int, cfg) -> int | None:
    """M-RoPE's rotary position of decode position pos: text tokens past the
    vision prefix sit at t = h = w = pos - nv + g; None for other models."""
    return pos - cfg.n_vision_tokens + _grid(cfg) if cfg.pos_embed == "mrope" else None


def _attn_block_decode(p, x, cfg, cache, pos: int):
    h, cache = decode_attention(
        p["attn"], rmsnorm(x, p["attn_norm"], cfg.norm_eps), cfg, cache, pos, _rope_pos(pos, cfg)
    )
    x = x + h
    m, _ = _ffn(p, rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg)
    return x + m, cache


def _mamba_block_apply(p, x, cfg):
    """Pre-norm Mamba2 block. Returns (x, state)."""
    h, state = _ssm.mamba2_apply(p["mixer"], rmsnorm(x, p["norm"], cfg.norm_eps), cfg)
    return x + h, state


def _mamba_block_x(p, x, cfg):
    return _mamba_block_apply(p, x, cfg)[0]


def _mamba_block_decode(p, x, cfg, state):
    h, state = _ssm.mamba2_decode(p["mixer"], rmsnorm(x, p["norm"], cfg.norm_eps), cfg, state)
    return x + h, state


def _xlstm_block_apply(p, x, cfg, slstm: bool):
    """An sLSTM block (no pre-norm: its norm is inside, after the
    recurrence) or a pre-norm mLSTM block, with its residual. Returns (x,
    state)."""
    if slstm:
        h, state = _xl.slstm_apply(p, x, cfg)
    else:
        h, state = _xl.mlstm_apply(p["mixer"], rmsnorm(x, p["norm"], cfg.norm_eps), cfg)
    return x + h, state


def _xlstm_block_x(p, x, cfg, slstm: bool):
    return _xlstm_block_apply(p, x, cfg, slstm)[0]


def _xlstm_block_decode(p, x, cfg, state, slstm: bool):
    if slstm:
        h, state = _xl.slstm_decode(p, x, cfg, state)
    else:
        h, state = _xl.mlstm_decode(p["mixer"], rmsnorm(x, p["norm"], cfg.norm_eps), cfg, state)
    return x + h, state


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and lists (a tuple is a leaf:
    the shape trees' leaves are tuples)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
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

    unbound = _tree_map(lambda t: t.unbind() if isinstance(t, Sharded) else torch.unbind(t),
                        blocks)
    return [walk(unbound, i) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
# The leaves drawn from the generator, in the order of one block's draws,
# with their init scale (None: 1/sqrt(fan_in)): an attention block's (the
# attention's, then the MLP's or the experts'), a Mamba2 block's; the
# others are the constants of :func:`_constant`.  An xLSTM block draws
# from its own table (group None: a leaf at the top of the block).
_DRAWN = (("attn", "wq", None), ("attn", "wk", None), ("attn", "wv", None),
          ("attn", "wo", None), ("mlp", "w_gate", None), ("mlp", "w_up", None),
          ("mlp", "w_down", None), *(("moe", name, None) for name in MOE_DRAWN),
          *(("mixer", name, scale) for name, scale in _ssm.DRAWN))
_XLSTM_DRAWN = {"mlstm": tuple(("mixer", name, scale) for name, scale in _xl.DRAWN["mlstm"]),
                "slstm": tuple((None, name, scale) for name, scale in _xl.DRAWN["slstm"])}
_ONES = ("attn_norm", "mlp_norm", "q_norm", "k_norm", "norm")


def _constant(name: str) -> float:
    """The value of a leaf that is not drawn: norms are ones, biases zeros,
    and a Mamba2 mixer's constants are the reference's."""
    if name in _ssm.CONSTANTS:
        return _ssm.CONSTANTS[name]
    return 1.0 if name in _ONES else 0.0


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """A leaf's dtype in a model of ``dtype``: a Mamba2 mixer's ``a_log``,
    ``d_skip`` and ``dt_bias`` and the xLSTM's gate biases ``b_gates`` and
    ``b`` stay float32."""
    return torch.float32 if name in _ssm.F32_PARAMS + _xl.F32_PARAMS else dtype


def _init_block(generator, shapes: dict, dtype, n: int | None, table=_DRAWN) -> dict:
    """A block's parameters: each leaf allocated once ((n,) + shape when
    stacked over n layers), the constants filled, then the drawn leaves,
    layer by layer in ``table``'s order (so the weights are never held
    twice, and the largest transient is one layer's float32 draw)."""
    dev = generator.device

    def alloc(tree, name=None):
        if isinstance(tree, dict):
            return {k: alloc(v, k) for k, v in tree.items()}
        return torch.full(tree, _constant(name), dtype=leaf_dtype(name, dtype), device=dev)

    block = alloc(shapes)
    drawn = [(block[group][name] if group else block[name], scale)
             for group, name, scale in table
             if (group in block and name in block[group]) or (group is None and name in block)]
    for i in range(n or 1):
        for leaf, scale in drawn:
            part = leaf[i] if n else leaf
            part.copy_(dense_init(generator, part.shape, dtype, scale))
    return block


def init_params(generator: torch.Generator, cfg) -> dict:
    """Seeded random parameters on ``generator``'s device, in ``cfg.dtype``
    (a Mamba2 mixer's ``a_log``, ``d_skip`` and ``dt_bias`` in float32).

    Each stacked leaf is allocated once, (L,) + shape, and layer i's draw
    goes into its slice, layer by layer in ``_DRAWN``'s order; so the
    weights are never held twice, and the largest transient is one leaf's
    float32 draw.  zamba2's shared block is drawn after the stack.  The
    xLSTM's list of blocks is drawn block by block, each in its mixer's
    order (``xlstm.DRAWN``).  The draws differ from the reference's (a
    torch Generator is not a JAX key); tests carry the reference's
    parameters across instead."""
    check_supported(cfg)
    dtype, dev = param_dtype(cfg), generator.device
    shapes = param_shapes(cfg)
    params: dict[str, Any] = {"embed": dense_init(generator, shapes["embed"], dtype)}
    if cfg.block_pattern == "xlstm":
        params["blocks"] = [
            _init_block(generator, sh, dtype, None,
                        _XLSTM_DRAWN["slstm" if i in cfg.slstm_indices else "mlstm"])
            for i, sh in enumerate(shapes["blocks"])]
    else:
        params["blocks"] = _init_block(generator, shapes["blocks"], dtype, cfg.n_layers)
    if "shared" in shapes:
        params["shared"] = _init_block(generator, shapes["shared"], dtype, None)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if "lm_head" in shapes:
        params["lm_head"] = dense_init(generator, shapes["lm_head"], dtype)
    return params


def _attn_block_shapes(cfg, lead: tuple) -> dict:
    """An attention block's shapes, each with ``lead`` in front ((L,) for
    the stack, () for zamba2's shared block)."""
    d, f = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn = {"wq": (d, H * hd), "wk": (d, K * hd), "wv": (d, K * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(H * hd,), bk=(K * hd,), bv=(K * hd,))
    if cfg.qk_norm:
        attn.update(q_norm=(hd,), k_norm=(hd,))
    block: dict[str, Any] = {"attn_norm": (d,), "attn": attn, "mlp_norm": (d,)}
    if cfg.is_moe:
        block["moe"] = moe_shapes(cfg)
    else:
        mlp = {"w_gate": (d, f)} if cfg.mlp_type == "swiglu" else {}
        mlp.update(w_up=(d, f), w_down=(f, d))
        block["mlp"] = mlp
    return _tree_map(lambda sh: lead + sh, block)


def param_shapes(cfg) -> dict:
    """The shape of every parameter, in the layout of :func:`init_params`
    (and of the reference's ``init_params`` pytree)."""
    check_supported(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    if cfg.block_pattern == "attn":
        blocks = _attn_block_shapes(cfg, (L,))
    elif cfg.block_pattern == "xlstm":
        blocks = [_xl.slstm_shapes(cfg) if i in cfg.slstm_indices
                  else {"norm": (d,), "mixer": _xl.mlstm_shapes(cfg)} for i in range(L)]
    else:
        blocks = {"norm": (L, d),
                  "mixer": {k: (L,) + sh for k, sh in _ssm.mamba2_shapes(cfg).items()}}
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    shapes: dict[str, Any] = {"embed": cb + (V, d), "blocks": blocks}
    if cfg.block_pattern == "zamba2":
        shapes["shared"] = _attn_block_shapes(cfg, ())
    shapes["final_norm"] = (d,)
    if cfg.n_codebooks or not cfg.tie_embeddings:
        shapes["lm_head"] = cb + (d, V)
    return shapes


def param_count(params) -> int:
    return sum(a.numel() for a in _leaves(params))


def _leaves(tree):
    """The leaves of nested dicts, lists and tuples, in insertion and index
    order; a tuple of ints (a shape, in :func:`param_shapes`) is a leaf."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list) or (
            isinstance(tree, tuple) and not all(isinstance(s, int) for s in tree)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# embedding / positions / head
# ---------------------------------------------------------------------------
def _embed(params, batch, cfg, span: tuple[int, int] | None = None):
    """Token embeddings (codebooks: their sum), the vision embeddings over
    the first ``n_vision_tokens`` positions, and sinusoidal positions; of
    positions [o, o + s) of the sequence with ``span`` (o, s)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    o, s = span or (0, S)
    if span is not None:
        tokens = tokens[:, o:o + s]
    if cfg.n_codebooks:
        x = params["embed"][0][tokens[..., 0]]
        for c in range(1, cfg.n_codebooks):
            x = x + params["embed"][c][tokens[..., c]]
    else:
        x = params["embed"][tokens]
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        nv = cfg.n_vision_tokens
        if S < nv:
            raise ValueError(f"{S} positions cannot hold the {nv} vision tokens")
        if span is None:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x[:, nv:]], dim=1)
        elif o < nv:
            k = min(nv - o, s)
            x = torch.cat([batch["vision_embeds"][:, o:o + k].to(x.dtype), x[:, k:]], dim=1)
    if cfg.pos_embed == "sinusoidal":
        pos = torch.arange(o, o + s, device=x.device)[None]
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


def _remat(rematted: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``rematted``."""
    return checkpoint(fn, *args, use_reentrant=False) if rematted else fn(*args)


def _zamba_group(layers, shared, x, cfg, positions, rematted: bool):
    """One zamba2 group: its Mamba2 layers (each rematerialized when
    ``rematted``), then the shared attention block."""
    for p in layers:
        x = _remat(rematted, _mamba_block_x, p, x, cfg)
    return _attn_block_apply(shared, x, cfg, positions)[0]


def forward(params, batch, cfg, *, remat: bool = True):
    """Run the stack; returns (hidden (B, S, d), aux_loss): the MoE
    balance losses summed over the layers in f32 (0.0 without experts),
    as the reference's scan carry sums them.

    With ``remat`` and grad mode on, each block runs under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    reference's ``jax.checkpoint`` per block: only the block's input is
    kept, and its forward (flash kernel included) runs again in the
    backward.  zamba2 nests it as the reference does: each group is
    rematerialized, and inside it each Mamba2 layer; the group's recompute
    keeps its layers' inputs and its shared block's activations.  Each mLSTM
    block is rematerialized on its own; an sLSTM block is not: its position
    loop saves a few (B, d) tensors a position, and a recompute would run
    its thousands of small kernels again.  The reference's forward takes no
    remat for xLSTM: the values are the same."""
    check_supported(cfg)
    x = _embed(params, batch, cfg)
    positions = _positions(batch, cfg)
    rematted = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if cfg.is_moe else 0.0
    if cfg.block_pattern == "xlstm":
        for i, p in enumerate(params["blocks"]):
            slstm = i in cfg.slstm_indices
            x = _remat(rematted and not slstm, _xlstm_block_x, p, x, cfg, slstm)
        return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux
    layers = _unstack(params["blocks"], cfg.n_layers)
    if cfg.block_pattern == "attn":
        for p in layers:
            x, a = _remat(rematted, _block_x, p, x, cfg, positions)
            aux = aux + a
    elif cfg.block_pattern == "mamba2":
        for p in layers:
            x = _remat(rematted, _mamba_block_x, p, x, cfg)
    else:
        every = cfg.shared_attn_every
        for g in range(cfg.n_layers // every):
            x = _remat(rematted, _zamba_group, layers[g * every:(g + 1) * every],
                       params["shared"], x, cfg, positions, rematted)
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
    return _ce_sum(hidden, head_w, labels, chunk) / torch.clamp((labels >= 0).sum(), min=1)


def _ce_sum(hidden, head_w, labels, chunk: int = LOSS_CHUNK):
    """:func:`chunked_ce_loss`'s summed CE over the valid positions, before
    the division by their count."""
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
    return tot


def loss_fn(params, batch, cfg, *, remat: bool = True, mesh=None, act_spec=None,
            logits_spec=None):
    """Scalar training loss: CE (averaged over codebooks) + AUX_LOSS_COEF *
    aux (aux is 0 without experts).  With ``mesh``: :func:`mesh_loss_fn`,
    which takes ``act_spec`` and ``logits_spec`` (the port's ``P``, laid
    out on ``mesh``); a spec without a mesh raises ``ValueError``."""
    if mesh is not None:
        return mesh_loss_fn(params, batch, cfg, mesh, remat=remat, act_spec=act_spec,
                            logits_spec=logits_spec)
    if act_spec is not None or logits_spec is not None:
        raise ValueError("act_spec and logits_spec lay activations out on a mesh: pass mesh=")
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


# ---------------------------------------------------------------------------
# the training loss on a mesh: one program a mesh device
# ---------------------------------------------------------------------------
def _splits(spec, dim: int) -> bool:
    """Whether ``spec`` (a :class:`~repro_torch.distributed.sharding.P` or
    None) puts ``model`` on dimension ``dim``."""
    if spec is None or len(spec) <= dim or spec[dim] is None:
        return False
    part = spec[dim]
    return "model" in ((part,) if isinstance(part, str) else tuple(part))


def _remat_devices(rematted: bool, fn, p, xs, *args):
    """``fn(p, xs, *args)`` (xs one tensor a mesh device) under remat, each
    x a tensor input of the checkpoint: what it keeps of the block is the
    devices' inputs, saved by autograd."""
    if not rematted:
        return fn(p, xs, *args)
    return checkpoint(lambda *ts: fn(p, list(ts), *args), *xs, use_reentrant=False)


def _mesh_mlp(params, hn, cfg, mesh, sp: bool):
    """The dense MLP on ``mesh``: tensor parallel over ``model`` (each
    device's ``d_ff`` columns of ``w_gate``/``w_up`` and rows of
    ``w_down``, the partial outputs all-reduced in model order) when the
    layout splits every weight over it (``d_ff`` divides the axis), else
    gathered whole and computed replicated.  ``sp``: hn are blocks of
    positions, all-gathered along the sequence first, and each device
    returns its block of positions (the partial outputs reduce-scattered)."""
    tp = mesh.shape.get("model", 1) > 1 and all(
        any("model" in axes for axes in sh.parts()) for sh in params.values())
    views = local_tree_views(params, ("model",) if tp else ())
    if sp:
        hn = mesh_all_gather(hn, mesh, 1)
    ms = [mlp_apply(v, h, cfg.mlp_type) for v, h in zip(views, hn)]
    if sp:
        return (mesh_reduce_scatter(ms, mesh, 1) if tp
                else [mesh_block(m, mesh, kd, 1) for kd, m in enumerate(ms)])
    return mesh_all_reduce(ms, mesh) if tp else ms


def _mesh_ffn(p, xs, cfg, mesh, sp: bool = False):
    """The block's MLP or MoE on ``mesh`` after its pre-norm, with the
    residual; returns (xs, aux).  Under ``sp`` the MoE runs on the whole
    sequence, gathered along it, and each device keeps its block of
    positions of the output."""
    mn = local_views(p["mlp_norm"])
    hn = [rmsnorm(x, n, cfg.norm_eps) for x, n in zip(xs, mn)]
    if cfg.is_moe:
        if sp:
            hn = mesh_all_gather(hn, mesh, 1)
        ms, aux = moe_mesh_apply(p["moe"], hn, cfg, mesh)
        if sp:
            ms = [mesh_block(m, mesh, kd, 1) for kd, m in enumerate(ms)]
    else:
        ms, aux = _mesh_mlp(p["mlp"], hn, cfg, mesh, sp), 0.0
    return [x + m for x, m in zip(xs, ms)], aux


def _mesh_attn_block_apply(p, xs, cfg, mesh, positions, sp: bool = False):
    """:func:`_attn_block_apply` on a mesh; returns (xs, aux, kvs): each
    device's output, the layer's global MoE aux loss (0.0 without experts)
    on the mesh's first device, and each device's (k, v)
    (:func:`~repro_torch.models.attention.mesh_attention`).  ``sp``: xs are
    the devices' blocks of positions, and so are the outputs."""
    an = local_views(p["attn_norm"])
    hs, kvs = mesh_attention(p["attn"], [rmsnorm(x, n, cfg.norm_eps) for x, n in zip(xs, an)],
                             cfg, mesh, positions, seq_parallel=sp)
    xs, aux = _mesh_ffn(p, [x + h for x, h in zip(xs, hs)], cfg, mesh, sp)
    return xs, aux, kvs


def _mesh_attn_block(p, xs, cfg, mesh, positions, sp: bool = False):
    """(xs, aux) of :func:`_mesh_attn_block_apply`."""
    xs, aux, _ = _mesh_attn_block_apply(p, xs, cfg, mesh, positions, sp)
    return xs, aux


# The weights that tensor parallelism by heads needs split over ``model``,
# a mixer's (``param_pspecs`` drops an axis that does not divide).
_TP_SPLIT = {"mamba2": ("in_proj", "out_proj"), "mlstm": ("w_up", "wq", "wk", "wv", "w_down"),
             "slstm": ("w_in", "w_out")}


def mixer_heads(cfg) -> int:
    """The heads of a recurrent mixer of ``cfg``, which tensor parallelism
    splits: the Mamba2's d_inner / ssm_head_dim, the xLSTM's n_heads."""
    if cfg.block_pattern == "xlstm":
        return cfg.n_heads
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


def _mixer_tp(p: dict, kind: str, cfg, mesh) -> bool:
    """Whether a recurrent mixer runs tensor parallel over ``model`` by
    heads: a model axis of M > 1 that divides its heads, over which the
    layout splits its projections (``_TP_SPLIT``; ``tp=False`` layouts do
    not)."""
    M = mesh.shape.get("model", 1)
    return M > 1 and mixer_heads(cfg) % M == 0 and all(
        any("model" in axes for axes in p[w].parts()) for w in _TP_SPLIT[kind])


def _mixer_tp_views(p: dict, mesh, ranges) -> list[dict]:
    """Each mesh device's parameters of a mixer under tensor parallelism by
    heads: every leaf restricted to what its model device reads
    (``ranges(j, M)``, a mixer's ``tp_ranges``), through
    :func:`~repro_torch.distributed.sharding.head_column_views`."""
    M = mesh.shape["model"]
    table = [ranges(mesh.coords(k)["model"], M) for k in range(mesh.size)]
    views = {name: head_column_views(sh, [t[name][1] for t in table], table[0][name][0])
             for name, sh in p.items()}
    return [{name: v[k] for name, v in views.items()} for k in range(mesh.size)]


def _mesh_mamba_block(p, xs, cfg, mesh, sp: bool):
    """A Mamba2 block on ``mesh``.  Tensor parallel over ``model`` by heads
    where :func:`_mixer_tp` allows: each device its heads' columns of
    ``in_proj`` (and all of B and C), its share of the conv, the scan on
    H / M heads, the gated norm over all of d_in through the summed
    squares of each device's channels (:func:`mesh_rmsnorm`), its rows of
    ``out_proj``; the partial outputs all-reduced, or with ``sp`` (xs
    blocks of positions, the normed input all-gathered along the sequence)
    reduce-scattered to each device's block.  Otherwise gathered whole on
    each device (``sp``: xs all-gathered, each device keeping its block of
    the output)."""
    if not _mixer_tp(p["mixer"], "mamba2", cfg, mesh):
        views = local_tree_views(p)
        if not sp:
            return [_mamba_block_x(v, x, cfg) for v, x in zip(views, xs)]
        full = mesh_all_gather(xs, mesh, 1)
        return [x + mesh_block(_ssm.mamba2_apply(v["mixer"],
                                                 rmsnorm(f, v["norm"], cfg.norm_eps), cfg)[0],
                               mesh, kd, 1)
                for kd, (v, x, f) in enumerate(zip(views, xs, full))]
    hn = [rmsnorm(x, n, cfg.norm_eps) for x, n in zip(xs, local_views(p["norm"]))]
    if sp:
        hn = mesh_all_gather(hn, mesh, 1)
    views = _mixer_tp_views(p["mixer"], mesh, lambda j, M: _ssm.tp_ranges(cfg, j, M))
    gated = [_ssm.mamba2_gated(v, h, cfg)[0] for v, h in zip(views, hn)]
    normed = mesh_rmsnorm(gated, [v["norm"] for v in views], mesh, cfg.norm_eps)
    ys = [g @ v["out_proj"] for g, v in zip(normed, views)]
    ys = mesh_reduce_scatter(ys, mesh, 1) if sp else mesh_all_reduce(ys, mesh)
    return [x + y for x, y in zip(xs, ys)]


def _mesh_zamba_group(layers, xs, shared, cfg, mesh, positions, rematted: bool, sp: bool):
    """One zamba2 group on ``mesh``: its Mamba2 layers (each under remat
    when ``rematted``), then the shared block; ``sp``: blocks of
    positions in and out, the reference's constraint points (after each
    Mamba2 layer; the shared block follows the attention rule)."""
    for p in layers:
        xs = _remat_devices(rematted, _mesh_mamba_block, p, xs, cfg, mesh, sp)
    return _mesh_attn_block(shared, xs, cfg, mesh, positions, sp)[0]


def _mesh_xlstm_block(p, xs, cfg, mesh, slstm: bool):
    """An sLSTM or mLSTM block on ``mesh`` (xs each device's whole
    sequence).  Tensor parallel over ``model`` by heads where
    :func:`_mixer_tp` allows: the sLSTM's recurrence on its heads' gate
    columns of ``w_in`` and its heads of ``r`` and ``b``; the mLSTM's whole
    xb (its columns of ``w_up``) and conv, then its heads' q, k, v, gates
    and z; the norm over all channels through the summed squares of each
    device's (:func:`mesh_rmsnorm`), its rows of ``w_out`` or ``w_down``,
    the partial outputs all-reduced.  Otherwise gathered whole on each
    device."""
    mixer = p if slstm else p["mixer"]
    if not _mixer_tp(mixer, "slstm" if slstm else "mlstm", cfg, mesh):
        return [_xlstm_block_x(v, x, cfg, slstm) for v, x in zip(local_tree_views(p), xs)]
    eps = cfg.norm_eps
    if slstm:
        views = _mixer_tp_views(p, mesh, lambda j, M: _xl.slstm_tp_ranges(cfg, j, M))
        hs = [_xl.slstm_hidden(v, x, cfg)[0] for v, x in zip(views, xs)]
        hs = mesh_rmsnorm(hs, [v["norm"] for v in views], mesh, eps)
        ys = [h @ v["w_out"] for h, v in zip(hs, views)]
    else:
        hn = [rmsnorm(x, n, eps) for x, n in zip(xs, local_views(p["norm"]))]
        views = _mixer_tp_views(p["mixer"], mesh, lambda j, M: _xl.mlstm_tp_ranges(cfg, j, M))
        outs = [_xl.mlstm_hidden(v, h, cfg) for v, h in zip(views, hn)]
        hs = mesh_rmsnorm([o[0] for o in outs], [v["norm"] for v in views], mesh, eps)
        ys = [(h * F.silu(o[1])) @ v["w_down"] for h, o, v in zip(hs, outs, views)]
    return [x + y for x, y in zip(xs, mesh_all_reduce(ys, mesh))]


def _spans(mesh, S: int) -> list[tuple[int, int]]:
    """Each device's (offset, length) of positions under sequence
    parallelism: equal blocks in model order (:func:`mesh_block`'s)."""
    M = mesh.shape["model"]
    return [(mesh.coords(kd)["model"] * (S // M), S // M) for kd in range(mesh.size)]


def _gather_positions(hs, spans, mesh, i: int, c: int, at) -> dict:
    """Positions [i, i + c) of the data rows of the devices ``at``: from
    hs (one tensor a device, its positions ``spans[kd]``) gathered over
    ``model`` from the members' pieces (an empty piece from a member that
    holds none of them), a copy on each member in ``at``; with ``spans``
    None (each device holds the whole sequence) its own, as is.  Returns
    {kd: (rows, c, d)}."""
    if spans is None:
        return {kd: hs[kd][:, i:i + c] for kd in at}
    out, wanted = {}, set(at)
    for kd in at:
        if kd in out:
            continue
        group = mesh.group(kd, ("model",))
        pieces, offsets = [], []
        for g in group:
            o, s = spans[g]
            a, b = max(i, o), min(i + c, o + s)
            pieces.append(hs[g].narrow(1, a - o, b - a) if b > a else hs[g].narrow(1, 0, 0))
            offsets.append((0, a - i if b > a else 0, 0))
        dests = [g for g in group if g in wanted]
        out.update(zip(dests, gather_blocks(pieces, offsets,
                                            (hs[kd].shape[0], c, hs[kd].shape[2]),
                                            [mesh.flat[g] for g in dests])))
    return out


def _head_views(params, cfg, keep, at=None) -> list:
    """The head, (d, V) or (n_cb, d, V), as each device of ``at`` uses it:
    gathered over every axis but ``keep`` (``("model",)``: its block of
    vocab columns)."""
    if cfg.tie_embeddings and not cfg.n_codebooks:
        return [e.T for e in local_views(params["embed"], keep, at)]
    return local_views(params["lm_head"], keep, at)


def _vocab_split(params, tok, cfg, mesh, logits_spec) -> bool:
    """Whether the CE runs vocab parallel: ``logits_spec`` puts ``model``
    on the vocab, the model axis has more than one device over which the
    batch's rows (``tok``) are not split, and the head's layout splits its
    vocab over ``model`` alone."""
    if not _splits(logits_spec, 2) or mesh.shape.get("model", 1) <= 1:
        return False
    if isinstance(tok, Sharded) and "model" in tok.parts()[0]:
        return False
    if cfg.tie_embeddings and not cfg.n_codebooks:
        sh, dim = params["embed"], -2
    else:
        sh, dim = params["lm_head"], -1
    return isinstance(sh, Sharded) and sh.parts()[dim] == ("model",)


def _vp_ce_chunk(mesh, spans, leaders, i: int, c: int, *ts):
    """One chunk of the vocab-parallel CE: positions [i, i + c) of each
    data row gathered on its model devices; each device's (rows, c, V / M)
    f32 logits from its block of head columns; the log-sum-exp combined
    over ``model`` (the max all-gathered, the summed exponentials
    all-reduced in member order); the label's logit from the device whose
    columns hold it (a masked pick, all-reduced); labels of -1 count
    nothing.  ts: the final-normed hidden, the head blocks (d, V / M) and
    the labels (rows, S), one a device each.  Returns each leader's summed
    CE."""
    n = mesh.size
    hs, heads, labels = list(ts[:n]), ts[n:2 * n], ts[2 * n:]
    hc = _gather_positions(hs, spans, mesh, i, c, range(n))
    logits = [(hc[kd] @ w).float() for kd, w in enumerate(heads)]
    top = [pk.amax(0) for pk in mesh_all_gather([lg.detach().amax(-1)[None] for lg in logits],
                                                mesh, 0)]
    sums = mesh_all_reduce([torch.exp(lg - t[..., None]).sum(-1) for lg, t in zip(logits, top)],
                           mesh)
    picks = []
    for kd, (lg, lab) in enumerate(zip(logits, labels)):
        vl = lg.shape[-1]
        col = lab[:, i:i + c].long() - mesh.coords(kd)["model"] * vl
        got = lg.gather(-1, col.clamp(0, vl - 1)[..., None])[..., 0]
        picks.append(torch.where((col >= 0) & (col < vl), got, 0.0))
    picks = mesh_all_reduce(picks, mesh)
    return tuple(torch.where(labels[kd][:, i:i + c] >= 0,
                             top[kd] + torch.log(sums[kd]) - picks[kd], 0.0).sum()
                 for kd in leaders)


def _vp_ce_sums(hs, heads, labels, spans, mesh, chunk: int = LOSS_CHUNK) -> list:
    """:func:`_ce_sum` of each data row, vocab parallel: hs the
    final-normed hidden (a block of positions, ``spans``, or with ``spans``
    None the whole sequence), heads the (d, V / M) blocks, labels (rows,
    S), one a mesh device each.  Chunked over the sequence as
    :func:`_ce_sum`, each chunk under checkpoint in grad mode, so that no
    device holds more than its (rows, c, V / M) f32 logits.  Returns the
    sums on the leaders (``mesh.leaders()``)."""
    S = labels[0].shape[1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"chunked_ce_loss: sequence {S} is not a multiple of the chunk {c}")
    leaders = mesh.leaders()
    tots = [torch.zeros((), dtype=torch.float32, device=mesh.flat[kd]) for kd in leaders]
    for i in range(0, S, c):
        fn = functools.partial(_vp_ce_chunk, mesh, spans, leaders, i, c)
        if torch.is_grad_enabled():
            got = checkpoint(fn, *hs, *heads, *labels, use_reentrant=False)
        else:
            got = fn(*hs, *heads, *labels)
        tots = [t + g for t, g in zip(tots, got)]
    return tots


def mesh_loss_fn(params, batch, cfg, mesh, *, remat: bool = True, act_spec=None,
                 logits_spec=None):
    """The training loss of :func:`loss_fn` on ``mesh``, on its first
    device.  params: ``Sharded`` leaves (``param_pspecs`` on ``mesh``);
    batch: leaves laid out by ``batch_pspec`` (row blocks over data).

    Every device runs the stack on its data row's rows: the embedding
    gathered whole, each block as :func:`_mesh_attn_block`,
    :func:`_mesh_mamba_block` or :func:`_mesh_xlstm_block` (tensor parallel
    where the heads split over ``model``), each under remat as in
    :func:`forward`.  The final norm, the head and the chunked CE run on
    each data row's first model device; the loss is the rows' CE sums over
    the rows' summed count of valid labels (a mean of the rows' means
    would weight unequal rows wrongly), summed in row order, plus
    AUX_LOSS_COEF times the layers' global MoE aux losses.

    ``act_spec`` with ``model`` on the sequence (``act_pspec``: Megatron-SP)
    on a model axis of M > 1: each device embeds and keeps its S / M
    positions of its rows between blocks (S % M must be 0; the positions
    of RoPE stay the whole sequence's); a tensor-parallel attention, MLP or
    Mamba2 mixer all-gathers its normed input along the sequence and
    reduce-scatters its partial outputs; any other block (one whose heads
    or ``d_ff`` do not split, the MoE) runs on the gathered
    sequence, and each device keeps its positions; the xLSTM gathers the
    sequence once, before its first block, as the reference splits only
    its embedding.  ``logits_spec`` with ``model`` on the vocab, where the
    head's layout splits V over ``model``: the CE runs vocab parallel on
    every device (:func:`_vp_ce_sums`); otherwise on the leaders, the
    sequence gathered there.  Without them, or on a model axis of 1, each
    device holds its data row's whole sequence throughout and the CE runs
    on the leaders."""
    check_supported(cfg)
    n, dev, eps = mesh.size, mesh.flat[0], cfg.norm_eps
    rows = [shard_of(batch, kd) for kd in range(n)]
    tok = batch["tokens"]
    S = rows[0]["tokens"].shape[1]
    spans = None
    if _splits(act_spec, 1) and mesh.shape.get("model", 1) > 1:
        M = mesh.shape["model"]
        if S % M:
            raise ValueError(f"sequence parallelism: a sequence of {S} positions does not "
                             f"split over a model axis of {M} devices")
        if isinstance(tok, Sharded) and "model" in tok.parts()[0]:
            raise ValueError("sequence parallelism splits the sequence over 'model', and the "
                             f"batch's rows are laid out over it too ({tok.spec})")
        spans = _spans(mesh, S)
    sp = spans is not None
    emb = local_views(params["embed"])
    xs = [_embed({"embed": e}, r, cfg, spans[kd] if sp else None)
          for kd, (e, r) in enumerate(zip(emb, rows))]
    del emb
    positions = [_positions(r, cfg) for r in rows]
    rematted = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=dev) if cfg.is_moe else 0.0
    if cfg.block_pattern == "xlstm":
        if sp:
            xs, spans = mesh_all_gather(xs, mesh, 1), None
        for i, p in enumerate(params["blocks"]):
            slstm = i in cfg.slstm_indices
            xs = _remat_devices(rematted and not slstm, _mesh_xlstm_block, p, xs, cfg, mesh,
                                slstm)
    else:
        layers = _unstack(params["blocks"], cfg.n_layers)
        if cfg.block_pattern == "attn":
            for p in layers:
                xs, a = _remat_devices(rematted, _mesh_attn_block, p, xs, cfg, mesh, positions,
                                       sp)
                aux = aux + a
        elif cfg.block_pattern == "mamba2":
            for p in layers:
                xs = _remat_devices(rematted, _mesh_mamba_block, p, xs, cfg, mesh, sp)
        else:
            every = cfg.shared_attn_every
            for g in range(cfg.n_layers // every):
                xs = _remat_devices(rematted, _mesh_zamba_group,
                                    layers[g * every:(g + 1) * every], xs, params["shared"],
                                    cfg, mesh, positions, rematted, sp)
    labels = [r["labels"] for r in rows]
    vocab = _vocab_split(params, tok, cfg, mesh, logits_spec)
    if vocab:
        leaders = mesh.leaders()
        hidden = [rmsnorm(x, f, eps) for x, f in zip(xs, local_views(params["final_norm"]))]
        heads = _head_views(params, cfg, ("model",))
    else:
        # the devices whose rows the CE takes: each data row's first model
        # device, or every device when the batch is split over ``model`` too
        # (the pure-DP layout of a small model)
        leaders = tok.owners() if isinstance(tok, Sharded) else mesh.leaders()
        if spans is not None:
            xs = _gather_positions(xs, spans, mesh, 0, S, leaders)
        norms = local_views(params["final_norm"], at=leaders)
        hidden = [rmsnorm(xs[kd], f, eps) for kd, f in zip(leaders, norms)]
        heads = _head_views(params, cfg, (), leaders)
        labels = [labels[kd] for kd in leaders]
    ce = 0.0
    for cb in range(cfg.n_codebooks or 1):
        pick = (lambda t, cb=cb: t[cb]) if cfg.n_codebooks else (lambda t: t)
        lab = [lb[..., cb] for lb in labels] if cfg.n_codebooks else labels
        if vocab:
            sums = _vp_ce_sums(hidden, [pick(w) for w in heads], lab, spans, mesh)
            lab = [lab[kd] for kd in leaders]
        else:
            sums = [_ce_sum(h, pick(w), lb) for h, w, lb in zip(hidden, heads, lab)]
        tot = ordered_sum(sums, dev)
        cnt = ordered_sum([(lb >= 0).sum() for lb in lab], dev)
        ce = ce + tot / torch.clamp(cnt, min=1)
    if cfg.n_codebooks:
        ce = ce / cfg.n_codebooks
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
def _stacked_zeros(one: dict, n: int) -> dict:
    return {name: torch.zeros((n,) + a.shape, dtype=a.dtype, device=a.device)
            for name, a in one.items()}


def init_decode_state(cfg, batch: int, max_len: int, device=None):
    """The decode state of every layer, stacked on a leading axis.  The
    attention stack: its KV cache, k/v (L, B, size, K, hd).  Mamba2: ssm
    (L, B, H, N, P) f32 and conv (L, B, W - 1, C).  zamba2: ``{"mamba":
    that, "shared_kv": the shared block's k/v (n_groups, B, max_len, K,
    hd)}``.  xLSTM: a list, a layer's state each (the sLSTM's (c, n, h, m)
    tuple, the mLSTM's {"C", "n", "m", "conv"})."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    if cfg.block_pattern == "xlstm":
        return [_xl.init_slstm_state(cfg, batch, dtype, device) if i in cfg.slstm_indices
                else _xl.init_mlstm_state(cfg, batch, dtype, device)
                for i in range(cfg.n_layers)]
    if cfg.block_pattern == "attn":
        return _stacked_zeros(init_kv_cache(cfg, batch, max_len, dtype, device), cfg.n_layers)
    mamba = _stacked_zeros(_ssm.init_mamba2_state(cfg, batch, dtype, device), cfg.n_layers)
    if cfg.block_pattern == "mamba2":
        return mamba
    return {"mamba": mamba, "shared_kv": _stacked_zeros(
        init_kv_cache(cfg, batch, max_len, dtype, device), attention_layers(cfg))}


def decode_step(params, token, state, pos: int, cfg):
    """One decode step.

    token: (B, 1) int (codebooks: (B, 1, n_cb)); pos: number of tokens
    already in the state.  Returns (logits (B, V) (codebooks: (B, n_cb,
    V)), state); the state (caches, Mamba2 states; the xLSTM's list, whose
    entries are replaced) is updated in place and returned.
    """
    return _decode_step(_ONE_DEVICE, params, token, state, pos, cfg)


def prefill(params, batch, cfg, max_len: int | None = None):
    """Process a full prompt; returns (last-position logits (B, V), or
    (B, n_cb, V) with codebooks, and the decode state).  Each attention
    layer's k/v go straight into the preallocated (L, B, size, K, hd)
    cache, in place (the reference stacks every layer's k/v, then copies
    the stack into its cache); each Mamba2 layer's final ssm state and conv
    tail into the stacked state; the xLSTM's final states replace the
    entries of its list."""
    return _prefill(_ONE_DEVICE, params, batch, cfg, max_len)


def _prefill(ops, params, batch, cfg, max_len):
    """:func:`prefill` on one device or on a mesh (``ops``)."""
    check_supported(cfg)
    B, S = batch["tokens"].shape[:2]
    rows = ops.rows(batch, B)
    x = ops.embed(params, rows, cfg)
    positions = ops.each(lambda r: _positions(r, cfg), rows)
    state = ops.new_state(cfg, B, max_len or S, x)
    if cfg.block_pattern in ("attn", "zamba2"):
        size = (state["k"] if cfg.block_pattern == "attn" else state["shared_kv"]["k"]).shape[2]
        if S > size and not (cfg.block_pattern == "attn" and cfg.sliding_window):
            raise ValueError(f"prompt of {S} tokens does not fit a cache of {size} slots")

    def step(p, h, _, slstm=False):
        if cfg.block_pattern == "xlstm":
            return _xlstm_block_apply(p, h, cfg, slstm)
        return _mamba_block_apply(p, h, cfg)

    x = _serve_blocks(ops, params, x, state, cfg,
                      lambda p, h, cache: ops.attn_prefill(p, h, cfg, positions, cache), step,
                      use_state=False)
    return ops.logits(params, x, cfg, B), state


def _decode_step(ops, params, token, state, pos: int, cfg):
    """:func:`decode_step` on one device or on a mesh (``ops``)."""
    check_supported(cfg)
    B = token.shape[0]
    x = ops.embed(params, ops.rows({"tokens": token}, B), cfg)
    if cfg.pos_embed == "sinusoidal":
        x = ops.each(lambda h: _at_position(h, pos, cfg), x)

    def step(p, h, st, slstm=False):
        if cfg.block_pattern == "xlstm":
            return _xlstm_block_decode(p, h, cfg, st, slstm)
        return _mamba_block_decode(p, h, cfg, st)

    x = _serve_blocks(ops, params, x, state, cfg,
                      lambda p, h, cache: ops.attn_decode(p, h, cfg, cache, pos), step,
                      use_state=True)
    return ops.logits(params, x, cfg, B), state


def _at_position(x, pos: int, cfg):
    """x embedded at position 0 (:func:`_embed` adds position 0's
    sinusoidal embedding to a single token), with pos's in its place."""
    dev = x.device
    x = x - sinusoidal_positions(torch.zeros((1, 1), dtype=torch.long, device=dev),
                                 cfg.d_model, x.dtype)
    return x + sinusoidal_positions(torch.full((1, 1), pos, dtype=torch.long, device=dev),
                                    cfg.d_model, x.dtype)


def _serve_blocks(ops, params, x, state, cfg, attn, step, use_state: bool):
    """The block loop of prefill and decode, on one device or on a mesh
    (``ops``): ``attn(p, x, cache)`` runs an attention block against its
    cache layer (written in place), ``step(p, x, layer_state, slstm) -> (x,
    new state)`` a recurrent block, whose new state ``ops.mixer`` keeps
    (``use_state`` False: prefill's blocks start from none).  Returns x."""
    if cfg.block_pattern == "xlstm":
        for i, p in enumerate(params["blocks"]):
            slstm = i in cfg.slstm_indices
            x = ops.mixer(p, x, state, i, functools.partial(step, slstm=slstm), use_state)
        return x
    layers = _unstack(params["blocks"], cfg.n_layers)
    if cfg.block_pattern == "attn":
        for p, cache in zip(layers, ops.layers(state)):
            x = attn(p, x, cache)
        return x
    zamba = cfg.block_pattern == "zamba2"
    states = ops.layers(state["mamba"] if zamba else state)
    caches = ops.layers(state["shared_kv"]) if zamba else None
    for i, p in enumerate(layers):
        x = ops.mixer(p, x, states, i, step, use_state)
        if zamba and (i + 1) % cfg.shared_attn_every == 0:
            x = attn(params["shared"], x, caches[i // cfg.shared_attn_every])
    return x


class _StackedLayers(list):
    """Each layer's state as views of a stacked state; assigning a layer's
    new state copies it into the stack, in place."""

    def __setitem__(self, i, state):
        for name, t in state.items():
            self[i][name].copy_(t)


class _OneDevice:
    """The serving loop's operations on one device: x a tensor, the decode
    state's leaves tensors."""

    def rows(self, batch, B):
        return batch

    def each(self, fn, *args):
        return fn(*args)

    def embed(self, params, batch, cfg):
        return _embed(params, batch, cfg)

    def new_state(self, cfg, B, max_len, x):
        return init_decode_state(cfg, B, max_len, x.device)

    def layers(self, tree) -> _StackedLayers:
        n = len(next(iter(tree.values())))
        return _StackedLayers({k: t[i] for k, t in tree.items()} for i in range(n))

    def mixer(self, p, x, states, i, step, use_state):
        x, states[i] = step(p, x, states[i])
        return x

    def attn_prefill(self, p, x, cfg, positions, cache):
        x, _, kv = _attn_block_apply(p, x, cfg, positions)
        for name, t in zip(("k", "v"), kv):
            fill_cache(cache[name], t, cfg)
        return x

    def attn_decode(self, p, x, cfg, cache, pos):
        return _attn_block_decode(p, x, cfg, cache, pos)[0]

    def logits(self, params, x, cfg, B):
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return _logits(x[:, -1], _head_weight(params, cfg))


_ONE_DEVICE = _OneDevice()


# ---------------------------------------------------------------------------
# serving on a mesh: one program a mesh device
# ---------------------------------------------------------------------------
def abstract_params(cfg, device="meta") -> dict:
    """Stand-ins of :func:`init_params`' tree: every leaf an uninitialised
    tensor of its shape and dtype on ``device`` (the meta device by
    default: nothing is allocated; the counterpart of ``jax.eval_shape``
    of the reference's ``init_params``)."""
    dtype = param_dtype(cfg)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return torch.empty(tree, dtype=leaf_dtype(name, dtype), device=device)

    return walk(param_shapes(cfg))


def _dp_index(mesh, kd: int) -> tuple[int, int]:
    """(index, count) of device ``kd``'s data row over the data axes."""
    c, idx, n = mesh.coords(kd), 0, 1
    for a in dp_axes(mesh):
        idx, n = idx * mesh.shape[a] + c[a], n * mesh.shape[a]
    return idx, n


def _device_rows(batch: dict, mesh, B: int) -> list[dict]:
    """Each mesh device's rows of ``batch``: the blocks of leaves laid out
    by ``batch_pspec``, or of full tensors its data row's rows when B
    divides the data axes (else every row, replicated), moved to it."""
    out = []
    for kd, dev in enumerate(mesh.flat):
        idx, n = _dp_index(mesh, kd)
        rows = slice(idx * (B // n), (idx + 1) * (B // n)) if B % n == 0 else slice(None)
        out.append({name: t.blocks[kd] if isinstance(t, Sharded) else to_device(t[rows], dev)
                    for name, t in batch.items()})
    return out


def _mesh_logits(params, xs, cfg, mesh, B: int):
    """The final norm and the head of the last position on each data row's
    first model device, the rows gathered in data order on the mesh's
    first device: (B, V) or (B, n_cb, V)."""
    leaders = mesh.leaders()
    norms = local_views(params["final_norm"], at=leaders)
    if cfg.tie_embeddings and not cfg.n_codebooks:
        heads = [e.T for e in local_views(params["embed"], at=leaders)]
    else:
        heads = local_views(params["lm_head"], at=leaders)
    outs = [_logits(rmsnorm(xs[kd], f, cfg.norm_eps)[:, -1], w)
            for kd, f, w in zip(leaders, norms, heads)]
    if len(outs) == 1 or outs[0].shape[0] == B:
        return outs[0]
    rows = outs[0].shape[0]
    return gather_blocks(outs, [(i * rows,) + (0,) * (outs[0].ndim - 1)
                                for i in range(len(outs))],
                         (B,) + tuple(outs[0].shape[1:]), [mesh.flat[0]])[0]


def _mesh_state_layers(tree) -> list[dict]:
    """Each layer of a stacked state tree of :class:`Sharded` leaves, as
    views of the blocks."""
    layers = {k: t.unbind() for k, t in tree.items()}
    return [{k: t[i] for k, t in layers.items()} for i in range(len(next(iter(layers.values()))))]


def _mesh_mixer(layer_params, xs, state, mesh, step, use_state: bool = True):
    """A recurrent block gathered whole (replicated) on each device:
    ``step(p, x, st) -> (x, new state)``, ``state`` a dict or tuple of
    :class:`Sharded` leaves, gathered over ``model`` for use (when
    ``use_state``; prefill starts from none), each device then keeping its
    block of the new state in place."""
    keep = dp_axes(mesh)
    views = local_tree_views(layer_params)
    keys = list(state) if isinstance(state, dict) else list(range(len(state)))
    gathered = {key: local_views(state[key], keep) for key in keys} if use_state else None
    out = []
    for kd, (v, x) in enumerate(zip(views, xs)):
        st = None
        if use_state:
            st = ({key: gathered[key][kd] for key in keys} if isinstance(state, dict)
                  else type(state)(gathered[key][kd] for key in keys))
        x, new = step(v, x, st)
        for key in keys:
            state[key].blocks[kd].copy_(own_part(state[key], kd, new[key], keep))
        out.append(x)
    return out


class _OnMesh:
    """The serving loop's operations on ``mesh``: x a list, one entry a
    mesh device (its data row's rows), the decode state's leaves
    :class:`Sharded`."""

    def __init__(self, mesh):
        self.mesh = mesh

    def rows(self, batch, B):
        return _device_rows(batch, self.mesh, B)

    def each(self, fn, *args):
        return [fn(*a) for a in zip(*args)]

    def embed(self, params, rows, cfg):
        return [_embed({"embed": e}, r, cfg) for e, r in zip(local_views(params["embed"]), rows)]

    def new_state(self, cfg, B, max_len, xs):
        shapes = init_decode_state(cfg, B, max_len, device="meta")
        specs = decode_state_pspecs(shapes, self.mesh.axis_names, cfg, self.mesh)
        return sharded_zeros(shapes, specs, self.mesh)

    def layers(self, tree) -> list[dict]:
        return _mesh_state_layers(tree)

    def mixer(self, p, xs, states, i, step, use_state):
        return _mesh_mixer(p, xs, states[i], self.mesh, step, use_state)

    def attn_prefill(self, p, xs, cfg, positions, cache):
        xs, _, kvs = _mesh_attn_block_apply(p, xs, cfg, self.mesh, positions)
        mesh_prefill_cache(cache, kvs, cfg, self.mesh, attention_tp(p["attn"], cfg, self.mesh))
        return xs

    def attn_decode(self, p, xs, cfg, cache, pos):
        an = local_views(p["attn_norm"])
        hs = mesh_decode_attention(p["attn"],
                                   [rmsnorm(x, n, cfg.norm_eps) for x, n in zip(xs, an)],
                                   cfg, self.mesh, cache, pos, _rope_pos(pos, cfg))
        return _mesh_ffn(p, [x + h for x, h in zip(xs, hs)], cfg, self.mesh)[0]

    def logits(self, params, xs, cfg, B):
        return _mesh_logits(params, xs, cfg, self.mesh, B)


def mesh_prefill(params, batch, cfg, mesh, max_len: int | None = None):
    """:func:`prefill` on ``mesh``: params ``Sharded`` by ``param_pspecs``;
    batch full tensors or leaves laid out by ``batch_pspec``.  Returns the
    last position's logits on the mesh's first device and the decode state
    as ``Sharded`` leaves laid out by ``decode_state_pspecs``.

    The block loop is :func:`prefill`'s, each device running its data
    row's rows (every row when the batch does not divide the data axes):
    attention blocks through
    :func:`~repro_torch.models.attention.mesh_attention` (the flash kernel
    on each device's heads), their k/v to the cache's owners
    (:func:`~repro_torch.models.attention.mesh_prefill_cache`); Mamba2 and
    xLSTM blocks gathered whole, each keeping its block of the final
    states."""
    return _prefill(_OnMesh(mesh), params, batch, cfg, max_len)


def mesh_decode_step(params, token, state, pos: int, cfg, mesh):
    """:func:`decode_step` on ``mesh``: token (B, 1) (codebooks: (B, 1,
    n_cb)), a full tensor or laid out by ``batch_pspec``; state from
    :func:`mesh_prefill` (updated in place).  Returns (logits on the mesh's
    first device, state)."""
    return _decode_step(_OnMesh(mesh), params, token, state, pos, cfg)
