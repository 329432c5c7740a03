"""Mixture-of-Experts FFN with grouped, capacity-bounded dispatch (the
reference's ``repro.models.moe``).

Top-k routing: a softmax gate over the experts in f32, its k largest taken
(equal gates: the lower expert index first, as ``jax.lax.top_k``), then
renormalised over the k.  Dispatch is grouped per batch row, GShard's
semantics: within a row each (token, choice) assignment, taken token-major,
gets the slot in its expert's buffer given by an exclusive cumsum of the
one-hot assignments; assignments at or past the capacity
``cap = max(int(capacity_factor * S * k / E), 1)`` are dropped.  The experts
are stacked SwiGLU FFNs run as one batched product per weight over the
buffer; the combine gathers each assignment's row back, weights it, and sums
the k choices of each token.  The Switch auxiliary load-balance loss is
returned beside the output.

Every write lands in a fixed place, so the forward and the backward are
bitwise repeatable (no atomic accumulation):

* the buffer is (E, B, cap + 1, d): each expert has one slot past its
  capacity where its dropped assignments go, written with zeros (so their
  order does not matter) and never read back with a nonzero weight; the
  kept assignments' slots are unique;
* the dispatch writes the buffer by assignment (its gradient is a gather)
  and the combine gathers it (its gradient writes each kept slot once and
  adds only zeros into the extra slots);
* the token rows are expanded over the k choices, not indexed, so their
  gradient is a fixed-order sum over k.

The layout (E, B, cap + 1, d) puts each expert's rows together, so that each
expert weight multiplies them in one ``torch.bmm`` without copying the
weights (the reference's buffer is (B, E, cap, d); the arithmetic is the
same).  The reference's ``act_spec`` sharding branch is the mesh path,
ROADMAP.md, Queue 1 item 10.  ``moe.dispatch`` and ``moe.combine`` are
``torch.profiler.record_function`` ranges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.common import dense_init

__all__ = ["moe_init", "moe_apply", "moe_shapes", "route", "capacity", "slots", "DRAWN"]

# The parameters in the order the reference's moe_init draws them.
DRAWN = ("router", "w_gate", "w_up", "w_down")


def moe_shapes(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}


def moe_init(generator: torch.Generator, cfg, dtype) -> dict:
    """One layer's seeded parameters, drawn in the reference's order.  As in
    the reference, a stacked expert weight's fan-in is its first axis (E)."""
    shapes = moe_shapes(cfg)
    return {name: dense_init(generator, shapes[name], dtype) for name in DRAWN}


def capacity(cfg, S: int) -> int:
    """Slots an expert has in one batch row of S tokens."""
    return max(int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts), 1)


def route(params, x, cfg):
    """Gates (B, S, E) f32 (softmax of f32 logits), the top k's
    renormalised weights (B, S, k) f32 and expert ids (B, S, k) int64.  A
    stable descending sort gives equal gates in index order, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order)."""
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = vals[..., :cfg.top_k], order[..., :cfg.top_k]
    return gates, w / w.sum(dim=-1, keepdim=True), idx


def slots(idx, E: int, cap: int):
    """For assignments ``idx`` (B, S, k), token-major within each row: the
    one-hot (B, E, S k) int32, each assignment's exclusive position in its
    expert (B, S k) and whether it is kept (position < cap).  The one-hot
    is laid out expert-major so that the cumsum runs along the innermost
    axis (a scan along an outer axis is an order of magnitude slower)."""
    B = idx.shape[0]
    fid = idx.reshape(B, -1)
    # a comparison, not F.one_hot, which checks the ids' range on the host
    onehot = (fid[:, None, :] == torch.arange(E, device=idx.device)[:, None]).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot, 1,
                       fid[:, None, :])[:, 0]
    return onehot, pos, pos < cap


def moe_apply(params, x, cfg):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss 0-d f32)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, S)
    gates, w, idx = route(params, x, cfg)
    with record_function("moe.dispatch"):
        onehot, pos, keep = slots(idx, E, cap)
        # Switch aux loss, global over the batch: its gradient flows through
        # the mean gate only (the counts are integers)
        me = gates.mean(dim=(0, 1))
        ce = onehot.sum(dim=(0, 2)).float() / (B * S)
        aux = E * torch.sum(me * ce)

        fid = idx.reshape(B, S * k)
        rows = torch.arange(B, device=x.device)[:, None]
        # slot (e, b, p) of the (E, B, cap + 1) buffer; dropped: p = cap
        slot = ((fid * B + rows) * (cap + 1) + torch.where(keep, pos, cap)).reshape(-1)
        xa = x[:, :, None, :].expand(B, S, k, d).reshape(B * S * k, d)
        contrib = torch.where(keep.reshape(-1, 1), xa, 0)
        buf = x.new_zeros((E * B * (cap + 1), d)).index_put((slot,), contrib)
        buf = buf.view(E, B * (cap + 1), d)
        del xa, contrib
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    out = torch.bmm(h, params["w_down"]).view(E * B * (cap + 1), d)
    del buf, h
    with record_function("moe.combine"):
        fw = (w.reshape(B, S * k).to(x.dtype) * keep.to(x.dtype)).reshape(-1, 1)
        ya = out[slot] * fw
        y = ya.view(B, S, k, d).sum(dim=2)
    return y.to(x.dtype), aux
