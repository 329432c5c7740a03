"""Mamba2 (SSD) mixer in plain PyTorch (the reference's ``repro.models.ssm``):
the chunked form for training and prefill, the O(1)-state recurrent form
for decode.

The chunked SSD scan never builds the (L x L) operator of the state-space
dual form: within-chunk (Q x Q) blocks plus a low-rank state recurrence
between chunks reproduce its action exactly, for any chunk length.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim heads, N =
ssm_state, one B/C group (all heads share B and C).  ``a_log``, ``d_skip``
and ``dt_bias`` are float32 whatever the model's dtype (:data:`F32_PARAMS`);
the scan runs in float32, its output is cast to the model's dtype before the
gated norm, as in the reference.

What differs from the reference, with the same values:

* the within-chunk decay is masked *before* the exponential.  The
  reference takes ``exp(cs_i - cs_j)`` over the whole (Q, Q) block and then
  zeroes the upper triangle; for i < j that difference is a sum of up to
  Q - 1 positive steps, past float32's exp limit at Q = 256, so the masked
  entries are inf and the backward multiplies a zero cotangent by them (NaN
  gradients).  Here the upper triangle is -inf before ``exp``: the forward
  values are the reference's, the gradient is finite;
* heads come before the (Q, Q) block, so the within-chunk product is one
  batched matmul over (b, chunk, head), and every contraction is a
  two-operand matmul in a fixed order;
* the recurrence between chunks (the reference's ``lax.scan``) is a Python
  loop over the chunks, in order, with no atomics: a train step repeats
  bitwise.

``mamba.conv`` and ``mamba.ssd`` are ``torch.profiler.record_function``
ranges around the causal convolution and the scan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.common import dense_init, rmsnorm

__all__ = [
    "mamba2_init",
    "mamba2_shapes",
    "mamba2_apply",
    "mamba2_gated",
    "tp_ranges",
    "mamba2_decode",
    "init_mamba2_state",
    "chunk_len",
    "DRAWN",
    "CONSTANTS",
    "F32_PARAMS",
]

# The drawn parameters in the reference's order, with their init scale
# (None: 1/sqrt(fan_in)); the others are constants.
DRAWN = (("in_proj", None), ("conv_w", 0.5), ("out_proj", None))
# Parameters kept in float32 in a model of another dtype.
F32_PARAMS = ("a_log", "d_skip", "dt_bias")


def chunk_len(L: int, chunk: int) -> int:
    """Largest divisor of L that is <= chunk.  The chunked scan is exact for
    any chunk length, so an awkward L gets a smaller chunk, not padding."""
    q = min(chunk, L)
    while L % q:
        q -= 1
    return q


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_state


def mamba2_shapes(cfg) -> dict:
    """One layer's parameter shapes, in the reference's layout."""
    d = cfg.d_model
    d_in, H, N = _dims(cfg)
    conv_ch = d_in + 2 * N
    return {"in_proj": (d, 2 * d_in + 2 * N + H), "conv_w": (cfg.conv_width, conv_ch),
            "conv_b": (conv_ch,), "a_log": (H,), "d_skip": (H,), "dt_bias": (H,),
            "norm": (d_in,), "out_proj": (d_in, d)}


# The constants: A = -exp(a_log) = -1, a unit skip, no dt bias, a unit norm.
CONSTANTS = {"conv_b": 0.0, "a_log": 0.0, "d_skip": 1.0, "dt_bias": 0.0, "norm": 1.0}


def mamba2_init(generator: torch.Generator, cfg, dtype) -> dict:
    """One layer's seeded parameters on ``generator``'s device: the drawn
    weights in :data:`DRAWN`'s order, the constants of the reference."""
    shapes, dev = mamba2_shapes(cfg), generator.device
    drawn = {name: dense_init(generator, shapes[name], dtype, scale) for name, scale in DRAWN}
    return {name: drawn[name] if name in drawn else torch.full(
        shapes[name], CONSTANTS[name],
        dtype=torch.float32 if name in F32_PARAMS else dtype, device=dev)
        for name in shapes}


def _local_dims(params, cfg):
    """(d_in, H, N) of the heads that ``params`` holds: the layer's, or a
    model device's share under tensor parallelism (``a_log`` has one entry
    a head)."""
    H = params["a_log"].shape[0]
    return H * cfg.ssm_head_dim, H, cfg.ssm_state


def tp_ranges(cfg, j: int, M: int) -> dict:
    """What model device ``j`` of ``M`` reads of each parameter of a layer
    under tensor parallelism by heads (heads [j H/M, (j+1) H/M)), as
    ``{name: (dim, [(start, stop), ...])}``: of ``in_proj``'s [z | x | B |
    C | dt] columns its heads' z, x and dt and all of B and C (every head
    reads them); the conv's channels of its x and of B and C; its heads of
    ``a_log``, ``d_skip``, ``dt_bias``; its channels of ``norm`` and its
    rows of ``out_proj``."""
    d_in, H, N = _dims(cfg)
    h0, h1 = j * H // M, (j + 1) * H // M
    c0, c1 = h0 * cfg.ssm_head_dim, h1 * cfg.ssm_head_dim
    dt = 2 * d_in + 2 * N
    conv = [(c0, c1), (d_in, d_in + 2 * N)]
    heads = (0, [(h0, h1)])
    return {"in_proj": (1, [(c0, c1), (d_in + c0, d_in + c1), (2 * d_in, dt), (dt + h0, dt + h1)]),
            "conv_w": (1, conv), "conv_b": (0, conv), "a_log": heads, "d_skip": heads,
            "dt_bias": heads, "norm": (0, [(c0, c1)]), "out_proj": (0, [(c0, c1)])}


def _split_proj(params, x, cfg):
    d_in, _, N = _local_dims(params, cfg)
    zxbcdt = x @ params["in_proj"]
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N],
            zxbcdt[..., 2 * d_in + 2 * N:])


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along L, then SiLU. xbc (B, L, C); w (W, C)."""
    W, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = pad[:, 0:L] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + L] * w[i]
    return F.silu(out + b)


def _ssd_chunked(xh, dt, a_log, bmat, cmat, chunk):
    """Chunked SSD scan, float32.

    xh (B, L, H, P) per-head inputs; dt (B, L, H) softplus'd steps; bmat,
    cmat (B, L, N), shared by the heads.  Returns y (B, L, H, P) and the
    final state (B, H, N, P)."""
    B, L, H, P = xh.shape
    N = bmat.shape[-1]
    Q = chunk_len(L, chunk)
    nc = L // Q

    a = dt * -torch.exp(a_log)  # (B, L, H) log-decay increments
    xc = (xh * dt[..., None]).reshape(B, nc, Q, H, P).permute(0, 1, 3, 2, 4)  # (B,nc,H,Q,P)
    cs = torch.cumsum(a.reshape(B, nc, Q, H), dim=2).transpose(2, 3)  # (B,nc,H,Q) inclusive
    bc = bmat.reshape(B, nc, Q, N)
    cc = cmat.reshape(B, nc, Q, N)

    # within-chunk: y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j dt_j,
    # the upper triangle -inf before the exponential
    upper = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).triu(1)
    decay = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(upper, float("-inf")))
    scores = cc @ bc.transpose(-1, -2)  # (B, nc, Q, Q)
    y = (decay * scores[:, :, None]) @ xc  # (B, nc, H, Q, P)
    del decay

    # each chunk's outgoing state: sum_j exp(cs_last - cs_j) B_j (x dt)_j
    decay_out = torch.exp(cs[..., -1:] - cs)  # (B, nc, H, Q)
    states = bc.transpose(-1, -2)[:, :, None] @ (xc * decay_out[..., None])  # (B,nc,H,N,P)

    # the recurrence between chunks, in order: the state entering chunk c
    chunk_decay = torch.exp(cs[..., -1])  # (B, nc, H)
    s = torch.zeros((B, H, N, P), dtype=xh.dtype, device=xh.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)  # (B, nc, H, N, P)

    # between chunks: C_i . S_in, decayed to position i
    y = y + torch.exp(cs)[..., None] * (cc[:, :, None] @ s_in)
    return y.permute(0, 1, 3, 2, 4).reshape(B, L, H, P), s


def mamba2_gated(params, x, cfg):
    """The mixer up to its gated norm, for the heads that ``params`` holds
    (the layer's, or a model device's share, :func:`tp_ranges`). x (B, L,
    d_model) -> (y * silu(z) (B, L, d_in) in x's dtype, the final ssm state
    (B, H, N, P) f32, the pre-conv inputs (B, L, C))."""
    d_in, H, N = _local_dims(params, cfg)
    P = cfg.ssm_head_dim
    B, L, _ = x.shape
    z, xbc_raw, dt_raw = _split_proj(params, x, cfg)
    with record_function("mamba.conv"):
        xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_in].reshape(B, L, H, P).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    with record_function("mamba.ssd"):
        y, state = _ssd_chunked(xs, dt, params["a_log"], xbc[..., d_in:d_in + N].float(),
                                xbc[..., d_in + N:].float(), cfg.chunk_size)
    y = y + params["d_skip"][:, None] * xs
    y = y.reshape(B, L, d_in).to(x.dtype)
    return y * F.silu(z), state, xbc_raw


def mamba2_apply(params, x, cfg):
    """Full-sequence Mamba2 mixer. x (B, L, d_model) -> (y, state): the
    final ssm state (B, H, N, P) f32 and the conv tail (B, W - 1, C), the
    last W - 1 pre-conv inputs, zero-padded in front when L < W - 1."""
    W, L = cfg.conv_width, x.shape[1]
    gated, state, xbc_raw = mamba2_gated(params, x, cfg)
    out = rmsnorm(gated, params["norm"], cfg.norm_eps) @ params["out_proj"]
    tail = xbc_raw[:, max(L - (W - 1), 0):]
    conv_state = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    return out, {"ssm": state, "conv": conv_state}


def init_mamba2_state(cfg, batch: int, dtype, device=None) -> dict:
    """Zero state of one layer: ssm (B, H, N, P) f32, conv (B, W - 1, C)."""
    d_in, H, N = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, N, cfg.ssm_head_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
    }


def mamba2_decode(params, x, cfg, state):
    """One-token recurrent step. x (B, 1, d) -> (y (B, 1, d), new state):
    the conv over [conv state, new input] and one state update."""
    d_in, H, N = _dims(cfg)
    P = cfg.ssm_head_dim
    B = x.shape[0]
    z, xbc_new, dt_raw = _split_proj(params, x, cfg)

    hist = torch.cat([state["conv"], xbc_new], dim=1)  # (B, W, C)
    # summed in f32 and rounded once, as the reference's einsum accumulates
    conv = (hist.float() * params["conv_w"].float()).sum(dim=1).to(x.dtype) + params["conv_b"]
    xbc = F.silu(conv)  # (B, C)

    xs = xbc[:, :d_in].reshape(B, H, P).float()
    bmat = xbc[:, d_in:d_in + N].float()
    cmat = xbc[:, d_in + N:].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(params["a_log"]))

    xdt = (dt[..., None] * xs)[:, :, None, :]  # (B, H, 1, P)
    s = state["ssm"] * decay[:, :, None, None] + bmat[:, None, :, None] * xdt
    y = (cmat[:, None, None, :] @ s)[:, :, 0]  # (B, H, P)
    y = y + params["d_skip"][:, None] * xs
    y = y.reshape(B, 1, d_in).to(x.dtype)
    out = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps) @ params["out_proj"]
    return out, {"ssm": s, "conv": hist[:, 1:]}
