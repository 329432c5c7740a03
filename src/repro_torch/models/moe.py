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
same).  ``moe.dispatch`` and ``moe.combine`` are
``torch.profiler.record_function`` ranges.

On a mesh, :func:`moe_mesh_apply` is the reference's ``act_spec`` branch
(``moe.py:89-113``), chosen by :func:`moe_branch`: with E a multiple of
the model axis M, expert parallelism (each model device runs the E / M
experts it holds); else, with the capacity a multiple of M, each model
device runs every expert on its block of capacity slots; else nothing is
split.  Each device routes its data row's tokens (the router is
replicated), writes only its part of the buffer, runs its experts, and
the model group all-gathers the experts' outputs (buffer rows move by
copies), so the combine is the single-device one.  Capacity is per
(expert, batch row), so splitting the batch changes no routing and no
drop.  The Switch aux loss stays global over the batch: the data rows'
mean gates and counts are summed in row order before their product (a
mean of the rows' aux losses is another number).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.distributed.collectives import ordered_sum
from repro_torch.distributed.sharding import local_views, mesh_all_gather
from repro_torch.models.common import dense_init

__all__ = ["moe_init", "moe_apply", "moe_mesh_apply", "moe_branch", "moe_shapes", "route",
           "capacity", "slots", "DRAWN"]

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
    E = cfg.n_experts
    cap = capacity(cfg, S)
    gates, w, idx = route(params, x, cfg)
    with record_function("moe.dispatch"):
        onehot, pos, keep = slots(idx, E, cap)
        aux = _aux(gates, onehot, E, B * S)
        buf, slot = _dispatch(x, idx, pos, keep, E, cap)
    out = _experts(params, buf).view(E * B * (cap + 1), d)
    del buf
    return _combine(out, slot, w, keep, x), aux


def _aux(gates, onehot, E: int, tokens: int):
    """The Switch aux loss over ``tokens`` tokens: its gradient flows
    through the mean gate only (the counts are integers)."""
    me = gates.mean(dim=(0, 1))
    ce = onehot.sum(dim=(0, 2)).float() / tokens
    return E * torch.sum(me * ce)


def _dispatch(x, idx, pos, keep, E: int, cap: int, branch: str | None = None, j: int = 0,
              M: int = 1):
    """Each assignment's slot (e, b, p) of the (E, B, cap + 1) buffer
    (dropped: p = cap), flattened, and the buffer (E', R, d) that this
    device fills: the whole (E, B (cap + 1)) for ``branch`` None; model
    device ``j``'s E / M experts for ``"expert"``; every expert's
    ``cap / M`` slots of block ``j`` a row, (E, B cap / M), for
    ``"capacity"``.  In the last two the assignments the device does not
    hold go to one spare row, written with zeros and cut off."""
    B, S, d = x.shape
    k = idx.shape[-1]
    fid = idx.reshape(B, S * k)
    rows = torch.arange(B, device=x.device)[:, None]
    slot = ((fid * B + rows) * (cap + 1) + torch.where(keep, pos, cap)).reshape(-1)
    xa = x[:, :, None, :].expand(B, S, k, d).reshape(B * S * k, d)
    if branch is None:
        contrib = torch.where(keep.reshape(-1, 1), xa, 0)
        buf = x.new_zeros((E * B * (cap + 1), d)).index_put((slot,), contrib)
        return buf.view(E, B * (cap + 1), d), slot
    if branch == "expert":
        El = E // M
        mine = keep & (fid >= j * El) & (fid < (j + 1) * El)
        lslot, lead = slot - j * El * B * (cap + 1), (El, B * (cap + 1))
    else:
        c = cap // M
        mine = keep & (pos >= j * c) & (pos < (j + 1) * c)
        lslot, lead = ((fid * B + rows) * c + pos - j * c).reshape(-1), (E, B * c)
    n_rows = lead[0] * lead[1]
    lslot = torch.where(mine.reshape(-1), lslot, n_rows)
    contrib = torch.where(mine.reshape(-1, 1), xa, 0)
    buf = x.new_zeros((n_rows + 1, d)).index_put((lslot,), contrib)[:n_rows]
    return buf.view(*lead, d), slot


def _experts(params, buf):
    """The experts' SwiGLU FFNs over their rows of the buffer (E', R, d)."""
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _combine(out, slot, w, keep, x):
    """Gather each assignment's row of ``out`` (E B (cap + 1), d) back,
    weight it, and sum the k choices of each token: (B, S, d) in x's
    dtype."""
    B, S, d = x.shape
    with record_function("moe.combine"):
        fw = (w.reshape(B, -1).to(x.dtype) * keep.to(x.dtype)).reshape(-1, 1)
        ya = out[slot] * fw
        y = ya.view(B, S, -1, d).sum(dim=2)
    return y.to(x.dtype)


def moe_branch(cfg, S: int, model_size: int) -> str | None:
    """The reference's choice on a model axis of ``model_size``:
    ``"expert"`` (E over the axis) when it divides the expert count, else
    ``"capacity"`` (the capacity slots over the axis) when it divides the
    capacity, else None (nothing split; also on a model axis of 1)."""
    if model_size <= 1:
        return None
    if cfg.n_experts % model_size == 0:
        return "expert"
    return "capacity" if capacity(cfg, S) % model_size == 0 else None


def moe_mesh_apply(params, xs: list, cfg, mesh) -> tuple[list, torch.Tensor]:
    """The MoE of one layer on a mesh.  params: the layer's leaves as
    :class:`~repro_torch.distributed.sharding.Sharded`; xs: each mesh
    device's (B_row, S, d) input (its data row's rows, replicated over the
    model axis).  Returns each device's output and the global aux loss on
    the mesh's first device.  On a (1, 1) mesh this is :func:`moe_apply`,
    op for op."""
    M = mesh.shape.get("model", 1)
    B, S, d = xs[0].shape
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, S)
    branch = moe_branch(cfg, S, M)
    # expert weights laid out E over 'model' are used as their blocks
    ep_blocks = branch == "expert" and "model" in params["w_gate"].parts()[-3]
    router = local_views(params["router"])
    weights = {name: local_views(params[name], ("model",) if ep_blocks else ())
               for name in ("w_gate", "w_up", "w_down")}
    outs, routed = [], []
    for kd, x in enumerate(xs):
        j = mesh.coords(kd).get("model", 0)
        gates, w, idx = route({"router": router[kd]}, x, cfg)
        wl = {name: weights[name][kd] for name in weights}
        if branch == "expert" and not ep_blocks:
            wl = {name: t.narrow(0, j * (E // M), E // M) for name, t in wl.items()}
        with record_function("moe.dispatch"):
            onehot, pos, keep = slots(idx, E, cap)
            buf, slot = _dispatch(x, idx, pos, keep, E, cap, branch, j, M)
        outs.append(_experts(wl, buf))
        routed.append((gates, w, onehot, keep, slot))
        del buf
    if branch == "expert":
        outs = mesh_all_gather(outs, mesh, 0)
    elif branch == "capacity":
        outs = mesh_all_gather([o.view(E, B, cap // M, d) for o in outs], mesh, 2)
        outs = [torch.cat([o, o.new_zeros((E, B, 1, d))], dim=2) for o in outs]
    ys = [_combine(o.reshape(E * B * (cap + 1), d), slot, w, keep, x)
          for o, (_, w, _, keep, slot), x in zip(outs, routed, xs)]
    return ys, _global_aux(routed, cfg, mesh, B * S)


def _global_aux(routed: list, cfg, mesh, tokens_a_row: int) -> torch.Tensor:
    """The Switch aux loss over the whole batch, from each data row's
    first model device: the rows' gate sums and assignment counts summed
    in row order on the mesh's first device, then divided by the global
    token count (on one data row: :func:`moe_apply`'s expression)."""
    leaders = mesh.leaders()
    E = cfg.n_experts
    if len(leaders) == 1:
        gates, _, onehot, _, _ = routed[leaders[0]]
        return _aux(gates, onehot, E, tokens_a_row)
    dev = mesh.flat[0]
    n = tokens_a_row * len(leaders)
    me = ordered_sum([routed[kd][0].sum(dim=(0, 1)) for kd in leaders], dev) / n
    ce = ordered_sum([routed[kd][2].sum(dim=(0, 2)) for kd in leaders], dev).float() / n
    return E * torch.sum(me * ce)
