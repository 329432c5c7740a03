"""Dry-run cells: (architecture x input shape x mesh) -> a function and its
arguments, laid out on an :class:`~repro_torch.distributed.sharding.LMMesh`
(the reference's ``repro.launch.cells``).

A *cell* is one entry of the assignment matrix.  LM cells run
``make_train_step(mesh=)``'s step (train shapes), :func:`mesh_prefill`
(prefill shapes) or :func:`mesh_decode_step` (decode shapes).  Elasticity
cells run the paper's AddMult at the paper's problem scales: the elements
in contiguous blocks over the mesh, each device's gather, element operator
and scatter, the L-vector summed in device order (``:dd``: the
domain-decomposed operator, ``core/paop_dd.py``).

The reference lowers each cell through GSPMD with shardings beside
abstract arguments.  The port has no GSPMD: the layout is in the arguments
themselves (``Sharded`` leaves, one block a mesh device), so a cell is its
function and laid-out arguments.  On a mesh of meta devices
(``launch/mesh.py::make_production_mesh``) every argument is a stand-in
built from shapes (``abstract_params``, ``init_decode_state(...,
device="meta")``, ``batch_shapes``): nothing is allocated, and running the
cell traces it (``launch/dryrun.py``).  On a mesh of cards,
``build_cell(..., seed=)`` draws the arguments with numpy from the seed, so
that a cell that fits can run there.

A train cell passes the reference's ``act_spec`` and ``logits_spec`` to
its step: ``act_pspec`` (sequence parallelism over ``model``) and the
vocab-parallel CE, but batch-only layouts for the xLSTM and the pure-DP
layout of a small model; ``Cell.meta`` records both, and ``act_layout``
says what each device holds.  In the tensor-parallel layout the Mamba2
(zamba2) and xLSTM mixers run tensor parallel by heads, as the attention
and the MLP do; the pure-DP layout (xlstm-125m, under
``SMALL_MODEL_PARAMS``) gathers every weight whole.  Serving cells gather
the mixers whole.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.configs.elasticity import ELASTICITY_SHAPES, ElasticityShape
from repro_torch.core import flops as _fl
from repro_torch.data.pipeline import batch_shapes, make_batch
from repro_torch.distributed.sharding import (
    P,
    _lm_map,
    act_pspec,
    batch_pspec,
    decode_state_pspecs,
    dp_axes,
    mesh_all_reduce,
    param_pspecs,
    place,
    sharded_zeros,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.trainer import TrainState, _requires_grad, make_train_step

__all__ = ["build_cell", "cell_ids", "Cell", "skip_reason", "SMALL_MODEL_PARAMS"]

SMALL_MODEL_PARAMS = int(5e8)  # below this, TP costs more than it saves

# The reference's prefill applies ``act_spec`` only to the MoE's dispatch,
# which ``moe_mesh_apply`` computes; decode has one position a row.
_PREFILL_LAYOUT = ("each device its data row's (rows, S, d), replicated over 'model' (the "
                   "reference's prefill splits the sequence nowhere; the MoE's dispatch is "
                   "expert or capacity parallel)")
_DECODE_LAYOUT = "each device its data row's (rows, 1, d): one position a row"

@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple  # laid out on ``mesh``: Sharded leaves, tensors on its devices
    mesh: Any
    meta: dict = dataclasses.field(default_factory=dict)

    def run(self):
        return self.fn(*self.args)


def skip_reason(arch: str, shape: str) -> str | None:
    """Assignment skip rules: long_500k only for sub-quadratic archs."""
    if arch == "elasticity":
        return None
    if shape == "long_500k":
        cfg = get_config(arch)
        if not cfg.sub_quadratic:
            return (
                "full-attention arch: 500k dense decode is quadratic-cost "
                "KV attention; skipped per assignment (see DESIGN.md)"
            )
    return None


def cell_ids(include_elasticity: bool = True) -> list[tuple[str, str]]:
    out = []
    for arch in ARCH_IDS:
        if arch == "elasticity":
            if include_elasticity:
                out += [("elasticity", s) for s in ELASTICITY_SHAPES]
            continue
        out += [(arch, s) for s in SHAPES if skip_reason(arch, s) is None]
    return out


# ---------------------------------------------------------------------------
# arguments: stand-ins on a meta mesh, numpy draws on a mesh of cards
# ---------------------------------------------------------------------------
def _draw(tree, seed: int):
    """Every tensor leaf of ``tree`` (meta stand-ins) drawn with numpy from
    ``seed``, on the host: a weight N(0, 1/fan_in), a vector N(0, 0.02^2),
    an integer leaf zeros."""
    rng = np.random.default_rng(seed)

    def leaf(_, t):
        if not t.dtype.is_floating_point:
            return torch.zeros(t.shape, dtype=t.dtype)
        scale = 1 / math.sqrt(t.shape[-2]) if t.ndim >= 2 else 0.02
        return torch.from_numpy(rng.standard_normal(t.shape, dtype=np.float32) * scale).to(t.dtype)

    return _lm_map(leaf, tree)


def _lay_out(tree, specs, mesh, seed):
    """``tree`` (meta stand-ins) laid out by ``specs``: zero blocks (on a
    meta mesh, nothing), or numpy draws from ``seed`` placed."""
    if seed is None:
        return sharded_zeros(tree, specs, mesh)
    return place(_draw(tree, seed), specs, mesh)


def _meta_batch(cfg, shape: ShapeConfig) -> dict:
    return {name: torch.empty(s, dtype=torch.from_numpy(np.zeros((), dt)).dtype, device="meta")
            for name, (s, dt) in batch_shapes(cfg, shape).items()}


def _batch(cfg, shape, specs, mesh, seed):
    if seed is None:
        return sharded_zeros(_meta_batch(cfg, shape), specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, seed).items()}
    if cfg.dtype != "float32" and "vision_embeds" in batch:
        batch["vision_embeds"] = batch["vision_embeds"].to(getattr(torch, cfg.dtype))
    return place(batch, specs, mesh)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _train_cell(arch: str, cfg, shape: ShapeConfig, mesh, seed) -> Cell:
    from repro_torch.models.transformer import abstract_params

    axes = tuple(mesh.axis_names)
    # Models too small to amortize tensor parallelism run pure-DP: the
    # 'model' axis becomes extra batch parallelism, params FSDP over 'data'.
    pure_dp = cfg.n_params() < SMALL_MODEL_PARAMS
    dp = dp_axes(mesh)
    if pure_dp and shape.global_batch % mesh.size == 0:
        dp = axes
    shapes = abstract_params(cfg)
    params = _requires_grad(_lay_out(shapes, param_pspecs(shapes, mesh, tp=not pure_dp), mesh,
                                     seed))
    state = TrainState(params=params, opt_state=adamw_init(params),
                       step=torch.zeros((), dtype=torch.int32, device=mesh.flat[0]))
    mb = _meta_batch(cfg, shape)
    bspec = (_lm_map(lambda _, t: P(dp, *(None,) * (t.ndim - 1)), mb) if pure_dp
             else batch_pspec(axes, mb))
    # the reference's choice: sequence-parallel activations, but the xLSTM's
    # per-token recurrences and the pure-DP layout shard the batch only
    if cfg.block_pattern == "xlstm" or pure_dp:
        aspec = P(dp, None, None)
        layout = ("pure DP: each device its own rows, every weight gathered whole" if pure_dp
                  else "each device its data row's (rows, S, d), replicated over 'model'")
    else:
        aspec = act_pspec(axes)
        layout = ("each device its data row's (rows, S / M, d) block of positions between "
                  "blocks (Megatron-SP over 'model')")
    lspec = P(dp, None, None if pure_dp else "model")
    meta = {"kind": "train", "tokens": shape.seq_len * shape.global_batch, "pure_dp": pure_dp,
            "act_spec": aspec, "logits_spec": lspec, "act_layout": layout}
    if cfg.block_pattern != "attn":
        meta["mixers"] = _mixer_layout(cfg, mesh, pure_dp)
    step = make_train_step(cfg, AdamWConfig(), remat=True, mesh=mesh, act_spec=aspec,
                           logits_spec=lspec)
    return Cell(arch=arch, shape=shape.name, fn=step,
                args=(state, _batch(cfg, shape, bspec, mesh, seed)), mesh=mesh, meta=meta)


def _mixer_layout(cfg, mesh, pure_dp: bool) -> str:
    """What a train cell's recurrent mixers compute on (the rule of
    ``models.transformer._mixer_tp``)."""
    from repro_torch.models.transformer import mixer_heads

    M, H = mesh.shape.get("model", 1), mixer_heads(cfg)
    if pure_dp or M == 1 or H % M:
        why = "pure DP" if pure_dp else f"{H} heads on a model axis of {M}"
        return f"gathered whole on each device ({why})"
    return f"tensor parallel by heads over 'model': {H // M} of {H} heads a device"


def _lm_params(cfg, mesh, seed):
    from repro_torch.models.transformer import abstract_params

    shapes = abstract_params(cfg)
    return _lay_out(shapes, param_pspecs(shapes, mesh), mesh, seed)


def _prefill_cell(arch: str, cfg, shape: ShapeConfig, mesh, seed) -> Cell:
    from repro_torch.models.transformer import mesh_prefill

    mb = {k: v for k, v in _meta_batch(cfg, shape).items() if k != "labels"}
    bspec = batch_pspec(tuple(mesh.axis_names), mb)
    if seed is None:
        batch = sharded_zeros(mb, bspec, mesh)
    else:
        batch = _batch(cfg, shape, {**bspec, "labels": bspec["tokens"]}, mesh, seed)
        batch.pop("labels")

    def fn(params, batch):
        return mesh_prefill(params, batch, cfg, mesh, max_len=shape.seq_len)

    return Cell(arch=arch, shape=shape.name, fn=fn, args=(_lm_params(cfg, mesh, seed), batch),
                mesh=mesh,
                meta={"kind": "prefill", "tokens": shape.seq_len * shape.global_batch,
                      "act_layout": _PREFILL_LAYOUT})


def _decode_cell(arch: str, cfg, shape: ShapeConfig, mesh, seed) -> Cell:
    from repro_torch.models.transformer import init_decode_state, mesh_decode_step

    B = shape.global_batch
    shapes = init_decode_state(cfg, B, shape.seq_len, device="meta")
    state = _lay_out(shapes, decode_state_pspecs(shapes, tuple(mesh.axis_names), cfg, mesh),
                     mesh, seed)
    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    # a full token tensor: each device takes its data row's rows, or every
    # row when the batch does not divide the data axes (tiny batch)
    token = torch.zeros(tok_shape, dtype=torch.int32, device=mesh.flat[0])

    def fn(params, token, state, pos):
        return mesh_decode_step(params, token, state, pos, cfg, mesh)

    return Cell(arch=arch, shape=shape.name, fn=fn,
                args=(_lm_params(cfg, mesh, seed), token, state, shape.seq_len - 1), mesh=mesh,
                meta={"kind": "decode", "tokens": B, "act_layout": _DECODE_LAYOUT})


# ---------------------------------------------------------------------------
# Elasticity cells (the paper's workload)
# ---------------------------------------------------------------------------
def _space(es: ElasticityShape):
    from repro_torch.fem.mesh import beam_hex
    from repro_torch.fem.space import H1Space

    m = beam_hex()
    for _ in range(es.n_h_refine):
        m = m.refined()
    return H1Space(m, es.p)


class _ElementBlocks:
    """A space's elements in ``n`` contiguous blocks: block k's gather ids
    and its nodes' incidence (each node's rows of the block's E-vector in
    element order, padding pointing at a zero row), built in numpy at first
    use."""

    def __init__(self, space, n: int):
        self.space, self.n = space, n
        self.per = space.nelem // n
        self._tables: dict[int, tuple] = {}

    def tables(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if k not in self._tables:
            self._tables[k] = self._build(k)
        return self._tables[k]

    def _build(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids = self.space.gather_ids[k * self.per:(k + 1) * self.per].reshape(-1).astype(np.int64)
        nodes, inv = np.unique(ids, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=nodes.size)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(ids.size) - np.repeat(start, counts)
        table = np.full((nodes.size, int(counts.max())), ids.size, np.int64)
        table[inv[order], slot] = order
        gather = ids.reshape(self.per, 1, -1) * 3 + np.arange(3).reshape(1, 3, 1)
        d = self.space.d1d
        return gather.reshape(self.per, 3, d, d, d), nodes, table

    def apply(self, k: int, op, x: torch.Tensor) -> torch.Tensor:
        """Block k's partial y = G_k^T D_k G_k x on x's device."""
        gather, nodes, table = (torch.from_numpy(a).to(x.device) for a in self.tables(k))
        lo = k * self.per
        x_e = x.reshape(-1)[gather]
        blk = op.with_material_weights(op.lam_w[lo:lo + self.per], op.mu_w[lo:lo + self.per],
                                       None)
        ye = blk._apply_evec(x_e)
        d3 = self.space.d1d ** 3
        rows = ye.new_empty((self.per * d3 + 1, 3))
        rows[-1] = 0
        rows[:-1].view(self.per, d3, 3).copy_(ye.reshape(self.per, 3, d3).transpose(-1, -2))
        g = rows[table]
        out = g[:, 0]
        for s in range(1, g.shape[1]):
            out = out + g[:, s]
        y = torch.zeros((self.space.nscalar, 3), dtype=ye.dtype, device=ye.device)
        y[nodes] = out
        return y


def _elasticity_cell(es: ElasticityShape, mesh, assembly: str, seed) -> Cell:
    """AddMult over the mesh: the elements in contiguous blocks over every
    mesh axis (the first dropped when the blocks would be uneven; devices
    along it then repeat their block), each device's gather, element
    operator and scatter of its block, the partial L-vectors summed in
    device order over the block axes.  On one device: the operator's own
    ``apply``.  The L-vector is replicated on every device."""
    from repro_torch.core.operators import ElasticityOperator

    space = _space(es)
    axes = tuple(mesh.axis_names)
    if space.nelem % math.prod(mesh.shape[a] for a in axes):
        axes = axes[1:]
    n = math.prod(mesh.shape[a] for a in axes)
    blocks = _ElementBlocks(space, n)

    @functools.lru_cache(maxsize=None)
    def op(device):  # built at the first apply: cell construction stays cheap
        return ElasticityOperator(space, assembly=assembly, dtype=torch.float32, device=device)

    def block_of(kd: int) -> int:
        c, idx = mesh.coords(kd), 0
        for a in axes:
            idx = idx * mesh.shape[a] + c[a]
        return idx

    def fn(xs):
        if n == 1:
            return [op(x.device).apply(x) for x in xs]
        ys = [blocks.apply(block_of(kd), op(x.device), x) for kd, x in enumerate(xs)]
        return mesh_all_reduce(ys, mesh, axes)

    x = torch.empty((space.nscalar, 3), dtype=torch.float32, device="meta")
    xs = _lay_out({"x": x}, {"x": P()}, mesh, seed)["x"]
    name = es.name + ("" if assembly == "paop" else f":{assembly}")
    return Cell(arch="elasticity", shape=name, fn=fn, args=(list(xs.blocks),), mesh=mesh,
                meta={"kind": "addmult", "assembly": assembly, "ndof": space.ndof,
                      "nelem": space.nelem, "p": es.p, "element_blocks": n,
                      "flops_per_elem": _fl.paop_flops_per_elem(es.p)
                      if assembly.startswith("paop") else _fl.dense_flops_per_elem(es.p)})


def _elasticity_dd_cell(es: ElasticityShape, mesh, seed) -> Cell:
    """The domain-decomposed AddMult (``SlabDecomposition``: per-shard
    applies and a halo exchange) over every device of the mesh."""
    from repro_torch.core.paop_dd import SlabDecomposition

    space = _space(es)
    dd = SlabDecomposition(space, mesh.flat, dtype=torch.float32)
    ln = dd.lnx * dd.lny * dd.lnz
    if seed is None:
        xb = tuple(torch.zeros((ln, 3), dtype=torch.float32, device=d) for d in mesh.flat)
    else:
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((space.nscalar, 3), dtype=np.float32))
        xb = dd.to_blocks(x)
    return Cell(arch="elasticity", shape=f"{es.name}:dd", fn=dd.apply_blocks, args=(xb,),
                mesh=mesh,
                meta={"kind": "addmult_dd", "assembly": "paop_dd", "ndof": space.ndof,
                      "nelem": space.nelem, "p": es.p, "grid": [dd.gx, dd.gy],
                      "flops_per_elem": _fl.paop_flops_per_elem(es.p)})


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------
def build_cell(arch: str, shape_name: str, mesh, assembly: str = "paop", *, cfg=None,
               shape: ShapeConfig | ElasticityShape | None = None,
               seed: int | None = None) -> Cell:
    """The cell (``arch``, ``shape_name``) on ``mesh``.  ``cfg`` and
    ``shape`` replace the named configuration and shape (a reduced model,
    a cut batch) under the same kind; ``seed`` draws the arguments with
    numpy (a mesh of cards) instead of zero stand-ins (a meta mesh)."""
    if arch == "elasticity":
        base, _, suffix = shape_name.partition(":")
        es = shape or ELASTICITY_SHAPES[base]
        if assembly == "paop_dd" or suffix == "dd":
            return _elasticity_dd_cell(es, mesh, seed)
        return _elasticity_cell(es, mesh, suffix or assembly, seed)
    cfg = cfg or get_config(arch)
    reason = skip_reason(arch, shape_name)
    if reason:
        raise ValueError(f"cell ({arch}, {shape_name}) skipped: {reason}")
    shape = shape or SHAPES[shape_name]
    build = {"train": _train_cell, "prefill": _prefill_cell, "decode": _decode_cell}
    if shape.kind not in build:
        raise ValueError(shape.kind)
    cell = build[shape.kind](arch, cfg, shape, mesh, seed)
    cell.shape = shape_name
    return cell
