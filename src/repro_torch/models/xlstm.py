"""xLSTM mixers in plain PyTorch (the reference's ``repro.models.xlstm``):
the mLSTM (matrix memory, chunkwise-parallel for training and prefill, the
O(1)-state recurrent form for decode) and the sLSTM (scalar memory, a
recurrence over every position).

* mLSTM: an exponential input gate and a log-sigmoid forget gate per head,
  the matrix memory C (dh x dh), the normalizer n and the stabilizer m;
  the output is h = (C q) / max(|n . q|, exp(-m)).  Shapes (``_mdims``):
  d_in = ssm_expand * d_model, H = n_heads, head dim d_in // H (the
  config's ``ssm_head_dim`` is not read, as in the reference).
* sLSTM: per-head scalar cell and normalizer with the block-diagonal
  recurrent feedback R h_{t-1} and the same stabilizer; head dim
  d_model // H.

``b_gates`` and ``b`` are float32 whatever the model's dtype
(:data:`F32_PARAMS`); both recurrences run in float32 and their output is
cast to the model's dtype before the norm, as in the reference.

What differs from the reference, with the same values:

* the chunked mLSTM puts heads before the (Q, Q) block, so every
  within-chunk contraction is one batched two-operand matmul over (b,
  chunk, head).  The carry between chunks (the reference's ``lax.scan``)
  is a Python loop over the chunks, in order, with no atomics; it yields
  each chunk's incoming (C, n, m), and the within-chunk outputs of all
  chunks are then computed at once from them;
* ``r`` is cast to float32 once per apply, not once per step, and laid
  out (H, dh, 4 dh) so that a step's recurrent product and its input
  projections are one head-batched ``baddbmm``; the carries are kept heads
  first, (H, B, dh), inside the loop (the state returned is (B, H, dh));
* the sLSTM's scan is a Python loop over the positions, in order;
* |n| is n: the normalizer never goes below 0.

The upper triangle of the within-chunk log weights is ``NEG`` (-1e30)
before its exponential and the carry's stabilizer starts at 0, both as in
the reference: the forward values and their gradients depend on both.
``torch.amax`` and ``torch.maximum`` split their gradient at ties, as
JAX's max does.

``xlstm.mlstm`` and ``xlstm.slstm`` are ``torch.profiler.record_function``
ranges around the two recurrences.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.common import dense_init, rmsnorm
from repro_torch.models.ssm import _causal_conv, chunk_len

__all__ = [
    "mlstm_init",
    "mlstm_shapes",
    "mlstm_apply",
    "mlstm_hidden",
    "mlstm_tp_ranges",
    "mlstm_decode",
    "init_mlstm_state",
    "slstm_init",
    "slstm_shapes",
    "slstm_apply",
    "slstm_hidden",
    "slstm_tp_ranges",
    "slstm_decode",
    "init_slstm_state",
    "DRAWN",
    "CONSTANTS",
    "F32_PARAMS",
    "NEG",
]

NEG = -1e30

# Each mixer's drawn parameters in the reference's order, with their init
# scale (None: 1/sqrt(fan_in)); the others are constants.
DRAWN = {
    "mlstm": (("w_up", None), ("conv_w", 0.5), ("wq", None), ("wk", None), ("wv", None),
              ("w_gates", None), ("w_down", None)),
    "slstm": (("w_in", None), ("r", 0.3), ("w_out", None)),
}
# The constants: zero biases, a unit norm.
CONSTANTS = {"conv_b": 0.0, "b_gates": 0.0, "b": 0.0, "norm": 1.0}
# Parameters kept in float32 in a model of another dtype.
F32_PARAMS = ("b_gates", "b")


def _init(generator: torch.Generator, shapes: dict, drawn, dtype) -> dict:
    dev = generator.device
    got = {name: dense_init(generator, shapes[name], dtype, scale) for name, scale in drawn}
    return {name: got[name] if name in got else torch.full(
        shapes[name], CONSTANTS[name],
        dtype=torch.float32 if name in F32_PARAMS else dtype, device=dev)
        for name in shapes}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mdims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def mlstm_shapes(cfg) -> dict:
    """One mLSTM mixer's parameter shapes, in the reference's layout."""
    d = cfg.d_model
    d_in, H, _ = _mdims(cfg)
    return {"w_up": (d, 2 * d_in), "conv_w": (cfg.conv_width, d_in), "conv_b": (d_in,),
            "wq": (d_in, d_in), "wk": (d_in, d_in), "wv": (d_in, d_in),
            "w_gates": (d_in, 2 * H), "b_gates": (2 * H,), "norm": (d_in,),
            "w_down": (d_in, d)}


def mlstm_init(generator: torch.Generator, cfg, dtype) -> dict:
    """One mLSTM mixer's seeded parameters on ``generator``'s device."""
    return _init(generator, mlstm_shapes(cfg), DRAWN["mlstm"], dtype)


def _scale(dh: int) -> float:
    """1 / sqrt(dh), rounded as the reference's float32 sqrt and division
    round it (a Python float that float32 holds exactly: no device copy)."""
    return float(torch.reciprocal(torch.sqrt(torch.tensor(float(dh)))))


def mlstm_tp_ranges(cfg, j: int, M: int) -> dict:
    """What model device ``j`` of ``M`` reads of each parameter of an mLSTM
    mixer under tensor parallelism by heads (heads [j H/M, (j+1) H/M)), as
    ``{name: (dim, [(start, stop), ...])}``: of ``w_up``'s [xb | z]
    columns all of xb (q and k come from the conv of all of it, v from all
    of it) and its heads' z; the whole conv; its heads' columns of ``wq``,
    ``wk``, ``wv``; its heads of ``w_gates``' and ``b_gates``' [li | lf];
    its channels of ``norm`` and its rows of ``w_down``."""
    d_in, H, dh = _mdims(cfg)
    h0, h1 = j * H // M, (j + 1) * H // M
    c = [(h0 * dh, h1 * dh)]
    gates = [(h0, h1), (H + h0, H + h1)]
    return {"w_up": (1, [(0, d_in), (d_in + h0 * dh, d_in + h1 * dh)]),
            "conv_w": (1, [(0, d_in)]), "conv_b": (0, [(0, d_in)]), "wq": (1, c),
            "wk": (1, c), "wv": (1, c), "w_gates": (1, gates), "b_gates": (0, gates),
            "norm": (0, c), "w_down": (0, c)}


def _mlstm_qkvg(params, x, cfg):
    d_in, _, dh = _mdims(cfg)
    H = params["b_gates"].shape[0] // 2  # the heads params holds
    B, L, _ = x.shape
    up = x @ params["w_up"]
    xb, z = up[..., :d_in], up[..., d_in:]
    xc = _causal_conv(xb, params["conv_w"], params["conv_b"])  # the q/k branch
    q = (xc @ params["wq"]).reshape(B, L, H, dh)
    k = (xc @ params["wk"]).reshape(B, L, H, dh)
    v = (xb @ params["wv"]).reshape(B, L, H, dh)
    gates = (xc @ params["w_gates"]).float() + params["b_gates"]
    return q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:]), z, xb


def _mlstm_chunked(q, k, v, li, lf, chunk):
    """Chunkwise stabilized mLSTM, float32.

    q, k, v (B, L, H, dh); li, lf (B, L, H) the log input and forget gates.
    Returns h (B, L, H, dh) and the final (C (B, H, dh, dh), n (B, H, dh),
    m (B, H))."""
    B, L, H, dh = q.shape
    Q = chunk_len(L, chunk)
    nc = L // Q

    def chunks(t):  # (B, L, H, e) -> (B, nc, H, Q, e)
        return t.float().reshape(B, nc, Q, H, -1).permute(0, 1, 3, 2, 4)

    qc = chunks(q) * _scale(dh)
    kc, vc = chunks(k), chunks(v)
    lic = li.reshape(B, nc, Q, H).transpose(2, 3)  # (B, nc, H, Q)
    fc = torch.cumsum(lf.reshape(B, nc, Q, H), dim=2).transpose(2, 3)  # inclusive

    # the carry between chunks, in order: the (C, n, m) entering chunk c.
    # wq_j = F_Q - F_j + li_j is position j's log weight at the chunk's end.
    f_end = fc[..., -1]  # (B, nc, H) each chunk's total log forget
    wq = f_end[..., None] - fc + lic  # (B, nc, H, Q)
    wq_max = torch.amax(wq, dim=-1)
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    c_in, n_in, m_in = [], [], []
    # each input unbound into per-chunk views once: its gradient is one
    # stack, not a zero-filled copy of the whole a chunk
    steps = zip(*(t.unbind(1) for t in (f_end, wq_max, wq, kc, vc)))
    for f_c, wq_max_c, wq_c, k_c, v_c in steps:
        c_in.append(C)
        n_in.append(n)
        m_in.append(m)
        m1 = torch.maximum(f_c + m, wq_max_c)
        decay = torch.exp(f_c + m - m1)  # (B, H)
        wk = torch.exp(wq_c - m1[..., None])[..., None] * k_c  # (B, H, Q, dh)
        C = decay[..., None, None] * C + wk.transpose(-1, -2) @ v_c
        n = decay[..., None] * n + wk.sum(dim=-2)
        m = m1
    c_in, n_in, m_in = torch.stack(c_in, 1), torch.stack(n_in, 1), torch.stack(m_in, 1)

    # within each chunk: the pairwise log weights W[t, j] = F_t - F_j + li_j
    # (t >= j), NEG above the diagonal, stabilized by m = max(F_t + m0,
    # max_j W[t, j])
    upper = torch.ones((Q, Q), dtype=torch.bool, device=q.device).triu(1)
    wlog = (fc[..., :, None] - fc[..., None, :] + lic[..., None, :]).masked_fill(upper, NEG)
    b = fc + m_in[..., None]  # (B, nc, H, Q) the carry's log decay at t
    mt = torch.maximum(b, torch.amax(wlog, dim=-1))
    c0 = torch.exp(b - mt)
    sw = (qc @ kc.transpose(-1, -2)) * torch.exp(wlog - mt[..., None])  # (B, nc, H, Q, Q)
    del wlog
    num = sw @ vc + c0[..., None] * (qc @ c_in)
    den = c0 * (qc @ n_in[..., None])[..., 0] + sw.sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-mt))[..., None]
    return h.permute(0, 1, 3, 2, 4).reshape(B, L, H, dh), (C, n, m)


def mlstm_hidden(params, x, cfg):
    """The mixer before its norm, for the heads that ``params`` holds (the
    layer's, or a model device's share, :func:`mlstm_tp_ranges`). x (B, L,
    d_model) -> (h (B, L, H dh) in x's dtype, z (B, L, H dh), xb (B, L,
    d_in), the final (C, n, m))."""
    B, L, _ = x.shape
    q, k, v, li, lf, z, xb = _mlstm_qkvg(params, x, cfg)
    with record_function("xlstm.mlstm"):
        h, state = _mlstm_chunked(q, k, v, li, lf, cfg.chunk_size)
    return h.reshape(B, L, -1).to(x.dtype), z, xb, state


def mlstm_apply(params, x, cfg):
    """Full-sequence mLSTM mixer. x (B, L, d_model) -> (y, state): the final
    C (B, H, dh, dh), n (B, H, dh), m (B, H), all f32, and the conv tail
    (B, W - 1, d_in), the last W - 1 pre-conv inputs, zero-padded in front
    when L < W - 1."""
    L, W = x.shape[1], cfg.conv_width
    h, z, xb, (C, n, m) = mlstm_hidden(params, x, cfg)
    out = (rmsnorm(h, params["norm"], cfg.norm_eps) * F.silu(z)) @ params["w_down"]
    tail = xb[:, max(L - (W - 1), 0):]
    return out, {"C": C, "n": n, "m": m, "conv": F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))}


def init_mlstm_state(cfg, batch: int, dtype, device=None) -> dict:
    """Zero state of one mLSTM layer: C, n, m f32, conv (B, W - 1, d_in)."""
    d_in, H, dh = _mdims(cfg)
    f32 = {"dtype": torch.float32, "device": device}
    return {"C": torch.zeros((batch, H, dh, dh), **f32), "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.zeros((batch, H), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_in), dtype=dtype, device=device)}


def mlstm_decode(params, x, cfg, state):
    """One-token recurrent step. x (B, 1, d) -> (y (B, 1, d), new state)."""
    d_in, H, dh = _mdims(cfg)
    B = x.shape[0]
    up = x @ params["w_up"]
    xb, z = up[..., :d_in], up[..., d_in:]
    hist = torch.cat([state["conv"], xb], dim=1)  # (B, W, d_in)
    # summed in f32 and rounded once, as the reference's einsum accumulates
    conv = (hist.float() * params["conv_w"].float()).sum(dim=1).to(x.dtype) + params["conv_b"]
    xc = F.silu(conv)
    q = (xc @ params["wq"]).reshape(B, H, dh).float()
    k = (xc @ params["wk"]).reshape(B, H, dh).float()
    v = (xb[:, 0] @ params["wv"]).reshape(B, H, dh).float()
    gates = (xc @ params["w_gates"]).float() + params["b_gates"]
    li, lf = gates[..., :H], F.logsigmoid(gates[..., H:])

    lfm = lf + state["m"]
    m = torch.maximum(lfm, li)
    fp, ip = torch.exp(lfm - m), torch.exp(li - m)
    C = fp[..., None, None] * state["C"] + ip[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fp[..., None] * state["n"] + ip[..., None] * k
    qs = q * _scale(dh)
    num = (qs[..., None, :] @ C)[..., 0, :]  # (B, H, dh)
    den = torch.maximum((n * qs).sum(dim=-1).abs(), torch.exp(-m))
    h = (num / den[..., None]).reshape(B, 1, d_in).to(x.dtype)
    out = (rmsnorm(h, params["norm"], cfg.norm_eps) * F.silu(z)) @ params["w_down"]
    return out, {"C": C, "n": n, "m": m, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_shapes(cfg) -> dict:
    """One sLSTM block's parameter shapes, in the reference's layout: the
    z, i, f, o input projections, the block-diagonal recurrent weights, the
    gate biases, the norm and the output projection."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {"w_in": (d, 4 * d), "r": (4, H, dh, dh), "b": (4, d), "norm": (d,),
            "w_out": (d, d)}


def slstm_init(generator: torch.Generator, cfg, dtype) -> dict:
    """One sLSTM block's seeded parameters on ``generator``'s device."""
    return _init(generator, slstm_shapes(cfg), DRAWN["slstm"], dtype)


def _slstm_cell(r2t, b, wx_t, carry):
    """One sLSTM step, heads first.  r2t (H, dh, 4 dh) f32, column g dh + d
    of head h's block being r[g, h, d]; b (H, 1, 4 dh) f32; wx_t (H, B,
    4 dh) f32 input projections; carry (c, n, h, m), each (H, B, dh) f32.

    17 kernels: the recurrent product and the input projections in one
    ``baddbmm`` (wx + R h, then + b, as the reference sums them); n = f n +
    i and c = f c + i z as ``addcmul``; |n| is n (n >= 0: each step adds
    i > 0 to f n)."""
    c, n, h, m = carry
    H, B = h.shape[:2]
    # unbound, not indexed: the four gates' gradients are one stack
    z, li, lf, o = (torch.baddbmm(wx_t, h, r2t) + b).view(H, B, 4, -1).unbind(2)
    z, lf, o = torch.tanh(z), F.logsigmoid(lf), torch.sigmoid(o)
    lfm = lf + m
    m_new = torch.maximum(lfm, li)
    fp = torch.exp(lfm - m_new)
    ip = torch.exp(li - m_new)
    c = torch.addcmul(fp * c, ip, z)
    n = torch.addcmul(ip, fp, n)
    h = o * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def slstm_tp_ranges(cfg, j: int, M: int) -> dict:
    """What model device ``j`` of ``M`` reads of each parameter of an sLSTM
    block under tensor parallelism by heads (heads [j H/M, (j+1) H/M)), as
    ``{name: (dim, [(start, stop), ...])}``: its heads' columns of each of
    ``w_in``'s four gates [z | i | f | o], its heads of ``r`` and of ``b``,
    its channels of ``norm`` and its rows of ``w_out``."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    h0, h1 = j * H // M, (j + 1) * H // M
    c = [(h0 * dh, h1 * dh)]
    return {"w_in": (1, [(g * d + h0 * dh, g * d + h1 * dh) for g in range(4)]),
            "r": (1, [(h0, h1)]), "b": (1, c), "norm": (0, c), "w_out": (0, c)}


def _slstm_weights(params):
    """``r`` as (H, dh, 4 dh) float32 (column g dh + d of head h's block is
    r[g, h, d]) and ``b`` as (H, 1, 4 dh), for the heads that ``params``
    holds."""
    _, H, dh, _ = params["r"].shape
    r2t = params["r"].float().permute(1, 3, 0, 2).reshape(H, dh, 4 * dh)
    return r2t, params["b"].reshape(4, H, dh).transpose(0, 1).reshape(H, 1, 4 * dh)


def _heads_first(wx, H: int):
    """(B, ..., 4 d) input projections -> (..., H, B, 4 dh) f32, contiguous:
    a step's slice is one head-batched operand of ``baddbmm``."""
    B, lead = wx.shape[0], wx.shape[1:-1]
    wx = wx.reshape(B, *lead, 4, H, -1).float()
    n = len(lead)
    order = (*range(1, n + 1), n + 2, 0, n + 1, n + 3)  # (..., H, B, 4, dh)
    return wx.permute(order).reshape(*lead, H, B, -1)


def slstm_hidden(params, x, cfg):
    """The sLSTM's recurrence, for the heads that ``params`` holds (the
    layer's, or a model device's share, :func:`slstm_tp_ranges`). x (B, L,
    d) -> (h (B, L, H dh) in x's dtype, the final carry heads first).  The
    positions are a Python loop, in order; the input projections are
    unbound into per-position views once (so the gradient of the whole is
    one stack of the positions' gradients, not a zero-filled copy each)."""
    B, L, _ = x.shape
    H, dh = params["r"].shape[1:3]
    wx = _heads_first(x @ params["w_in"], H).unbind(0)  # L x (H, B, 4 dh)
    r2t, b = _slstm_weights(params)
    carry = tuple(torch.zeros((B, H, dh), dtype=torch.float32, device=x.device).transpose(0, 1)
                  for _ in range(4))
    hs = []
    with record_function("xlstm.slstm"):
        for t in range(L):
            carry = _slstm_cell(r2t, b, wx[t], carry)
            hs.append(carry[2])
        h = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, L, H * dh).to(x.dtype)
    return h, carry


def slstm_apply(params, x, cfg):
    """Full-sequence sLSTM block (its norm after the recurrence, no
    pre-norm). x (B, L, d) -> (y, (c, n, h, m)), the final carry."""
    h, carry = slstm_hidden(params, x, cfg)
    y = rmsnorm(h, params["norm"], cfg.norm_eps) @ params["w_out"]
    return y, tuple(t.transpose(0, 1) for t in carry)


def init_slstm_state(cfg, batch: int, dtype=None, device=None) -> tuple:
    """Zero state of one sLSTM layer: (c, n, h, m), each (B, H, dh) f32
    (``dtype`` is accepted for the reference's signature)."""
    H = cfg.n_heads
    return tuple(torch.zeros((batch, H, cfg.d_model // H), dtype=torch.float32, device=device)
                 for _ in range(4))


def slstm_decode(params, x, cfg, carry):
    """One-token sLSTM step. x (B, 1, d) -> (y (B, 1, d), new carry)."""
    B, _, d = x.shape
    wx = _heads_first(x[:, 0] @ params["w_in"], cfg.n_heads)
    r2t, b = _slstm_weights(params)
    carry = _slstm_cell(r2t, b, wx, tuple(t.transpose(0, 1) for t in carry))
    h = carry[2].transpose(0, 1).reshape(B, 1, d).to(x.dtype)
    y = rmsnorm(h, params["norm"], cfg.norm_eps) @ params["w_out"]
    return y, tuple(t.transpose(0, 1) for t in carry)
