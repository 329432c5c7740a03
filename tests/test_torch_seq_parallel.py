"""Sequence parallelism (the reference's ``act_spec``) and the
vocab-parallel chunked CE (``logits_spec``) in the mesh train step, against
the unsharded step, the step without them and the reference.

Reduced configurations in float32 on virtual CPU devices, one PyTorch
thread (as ``tests/test_torch_lm_mesh.py``).  Tolerances:

* (1, 2) and (2, 2) with ``act_pspec`` and ``P(dp, None, "model")``: loss
  and grad norm to 1e-5 relative of the unsharded step, each AdamW moment
  leaf to 1e-5 of its max |unsharded|; a given mesh bitwise repeatable;
* where the specs change nothing, bitwise: (1, 1) is the unsharded step,
  (2, 1) the mesh step without specs;
* three qwen3 steps on (2, 2) against the reference by the rules of
  ``test_three_mesh_steps_match_reference`` (1e-4);
* the vocab-parallel CE alone against ``chunked_ce_loss``: value and its
  gradients with respect to the hidden and the head to 1e-6 relative (of
  max |.|), f32;
* the MoE's expert ids, the bytes autograd saves and the collectives'
  link bytes: exact.
"""

from __future__ import annotations

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as ref_base
from repro.launch import cells as ref_cells
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch.configs import base
from repro_torch.convert import train_state
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import collectives
from repro_torch.distributed.elastic import reshard_state
from repro_torch.distributed.sharding import (
    P,
    _lm_items,
    act_pspec,
    batch_pspec,
    gather,
    mesh_block,
    place,
    state_pspecs,
)
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import _leaves, chunked_ce_loss, loss_fn, mesh_loss_fn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import _requires_grad, make_train_step, train_state_init

TOL = 1e-5
SHAPE = base.ShapeConfig("t", "train", 32, 4)
OPT = AdamWConfig(total_steps=3, warmup_steps=1)
# dense GQA (tied head), experts, Mamba2 groups with a shared block,
# codebooks, vision embeddings
ARCHS = ["qwen3_17b", "olmoe_1b_7b", "zamba2_27b", "musicgen_medium", "qwen2_vl_7b"]
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return dataclasses.replace(base.get_reduced(arch), dtype="float32")


def _mesh(dm):
    return make_local_mesh(dm[1], devices=("cpu",) * (dm[0] * dm[1]))


def _specs(mesh):
    return {"act_spec": act_pspec(mesh.axis_names), "logits_spec": P("data", None, "model")}


def _batch(cfg, i, shape=SHAPE):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, i).items()}


def _state(cfg, mesh):
    state = train_state_init(torch.Generator().manual_seed(0), cfg)
    if mesh is not None:
        state = reshard_state(state, state_pspecs(state, mesh), mesh)
        _requires_grad(state.params)
    return state


def _step(cfg, mesh, specs=None, shape=SHAPE):
    """One step from the seed-0 state: (metrics, the state gathered on the
    host)."""
    step = make_train_step(cfg, OPT, mesh=mesh, **(specs or {}))
    state, m = step(_state(cfg, mesh), _batch(cfg, 0, shape))
    m = {k: v.detach().clone() for k, v in m.items()}
    return m, (gather(state, "cpu") if mesh is not None else state)


_UNSHARDED: dict = {}


def _unsharded(arch):
    if arch not in _UNSHARDED:
        _UNSHARDED[arch] = _step(_cfg(arch), None)
    return _UNSHARDED[arch]


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _bitwise(a, b):
    return all(torch.equal(x.detach(), y.detach()) for x, y in
               zip(_leaves([a.params, a.opt_state]), _leaves([b.params, b.opt_state])))


def _same_metrics(m, r):
    return all(torch.equal(m[k], r[k]) for k in r)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dm", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_step_matches_the_unsharded_step_and_repeats(arch, dm):
    rm, rs = _unsharded(arch)
    mesh = _mesh(dm)
    m, s = _step(_cfg(arch), mesh, _specs(mesh))
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(m[k], rm[k]) <= TOL, (k, float(m[k]), float(rm[k]))
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(_lm_items(s.opt_state[name]),
                                     _lm_items(rs.opt_state[name])):
            assert _rel(a, b) <= TOL, (name, path, _rel(a, b))
    m2, s2 = _step(_cfg(arch), mesh, _specs(mesh))
    assert _same_metrics(m2, m) and _bitwise(s2, s)


@pytest.mark.parametrize("arch", ["qwen3_17b", "zamba2_27b"])
def test_specs_on_one_by_one_mesh_are_the_unsharded_step_bitwise(arch):
    rm, rs = _unsharded(arch)
    mesh = _mesh((1, 1))
    m, s = _step(_cfg(arch), mesh, _specs(mesh))
    assert _same_metrics(m, rm) and _bitwise(s, rs)


@pytest.mark.parametrize("arch", ["qwen3_17b", "musicgen_medium"])
def test_specs_on_a_model_axis_of_one_are_the_mesh_step_bitwise(arch):
    """(2, 1): nothing to split over ``model``; the step without specs."""
    mesh = _mesh((2, 1))
    m, s = _step(_cfg(arch), mesh, _specs(mesh))
    m0, s0 = _step(_cfg(arch), mesh)
    assert _same_metrics(m, m0) and _bitwise(s, s0)


def test_three_sequence_parallel_steps_match_reference():
    """qwen3-1.7b reduced on (2, 2) with both specs from the reference's
    initial state: each step's loss, grad norm and lr, the final moments
    and every element of the final parameters to 1e-4 (of max |reference|
    a leaf)."""
    rel = 1e-4
    cfg = _cfg("qwen3_17b")
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    rstate = ref_trainer.train_state_init(jax.random.PRNGKey(0), rcfg)
    mesh = _mesh((2, 2))
    state = train_state(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    state = reshard_state(state, state_pspecs(state, mesh), mesh)
    _requires_grad(state.params)
    rstep = jax.jit(ref_trainer.make_train_step(rcfg, ref_adamw.AdamWConfig(
        **dataclasses.asdict(OPT))))
    step = make_train_step(cfg, OPT, mesh=mesh, **_specs(mesh))
    for i in range(3):
        batch = make_batch(cfg, SHAPE, i)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(rm[k])) <= rel * abs(float(rm[k])), k
    got = gather(state, "cpu")
    ref = jax.tree.map(np.asarray, rstate)
    for tree, rtree in ((got.params, ref.params), (got.opt_state["m"], ref.opt_state["m"]),
                        (got.opt_state["v"], ref.opt_state["v"])):
        flat, _ = jax.tree_util.tree_flatten_with_path(rtree)
        want = {jax.tree_util.keystr(kp): leaf for kp, leaf in flat}
        for path, a in _lm_items(tree):
            assert _rel(a, torch.from_numpy(np.asarray(want[path], np.float32))) <= rel, path


def test_moe_expert_ids_under_sequence_parallelism_are_the_unsharded_runs():
    """olmoe reduced on (2, 2) (expert parallel): the MoE runs on the
    gathered sequence, so each forward layer's ids on a data row's first
    model device, concatenated over the rows, are the unsharded run's,
    and a row's model devices route alike."""
    cfg = _cfg("olmoe_1b_7b")
    mesh = _mesh((2, 2))

    def routed(mesh, specs=None):
        kept, inner = [], moe.route

        def keeping(params, x, cfg):
            out = inner(params, x, cfg)
            kept.append(out[2].clone())
            return out

        moe.route = keeping
        try:
            _step(cfg, mesh, specs)
        finally:
            moe.route = inner
        return kept

    want = routed(None)[:cfg.n_layers]
    got = routed(mesh, _specs(mesh))[:cfg.n_layers * mesh.size]
    for layer, ids in enumerate(want):
        per = got[layer * mesh.size:(layer + 1) * mesh.size]
        assert torch.equal(torch.cat([per[k] for k in mesh.leaders()]), ids)
        assert all(torch.equal(per[k], per[2 * (k // 2)]) for k in range(mesh.size))


# ---------------------------------------------------------------------------
# the vocab-parallel CE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,chunk", [("untied", 8), ("untied", 32), ("tied", 8),
                                        ("codebooks", 16), ("masked chunk", 8)])
def test_vocab_parallel_ce_matches_chunked_ce_loss(case, chunk):
    """On (2, 2): each device's block of positions of its data row's rows
    and its block of vocab columns (a chunk of 8 inside a block, 32
    across both), against ``chunked_ce_loss`` on the whole: the mean CE
    and its gradients with respect to the hidden and the head."""
    B, S, d, V, n_cb = 4, 32, 16, 64, 3
    mesh = _mesh((2, 2))
    g = torch.Generator().manual_seed(7)
    hidden = torch.randn(B, S, d, generator=g, requires_grad=True)
    shape = {"tied": (V, d), "codebooks": (n_cb, d, V)}.get(case, (d, V))
    head = torch.randn(*shape, generator=g).mul_(0.3).requires_grad_(True)
    labels = torch.randint(0, V, (B, S) + ((n_cb,) if case == "codebooks" else ()), generator=g)
    labels[torch.rand(labels.shape, generator=g) < 0.2] = -1
    if case == "masked chunk":
        labels[:, 8:16] = -1
    spans = tf._spans(mesh, S)
    rows = [slice(2 * mesh.coords(kd)["data"], 2 * mesh.coords(kd)["data"] + 2)
            for kd in range(mesh.size)]
    hs = [mesh_block(hidden[r], mesh, kd, 1) for kd, r in enumerate(rows)]
    want, got = 0.0, 0.0
    for cb in range(n_cb if case == "codebooks" else 1):
        w = head[cb] if case == "codebooks" else head.T if case == "tied" else head
        lab = labels[..., cb] if case == "codebooks" else labels
        want = want + chunked_ce_loss(hidden, w, lab, chunk)
        heads = [mesh_block(w, mesh, kd, 1) for kd in range(mesh.size)]
        sums = tf._vp_ce_sums(hs, heads, [lab[r] for r in rows], spans, mesh, chunk)
        got = got + collectives.ordered_sum(sums, mesh.flat[0]) / (lab >= 0).sum()
    assert _rel(got, want) <= 1e-6
    gw = torch.autograd.grad(want, (hidden, head))
    gg = torch.autograd.grad(got, (hidden, head))
    for a, b in zip(gg, gw):
        assert _rel(a, b) <= 1e-6


class _Shapes(TorchDispatchMode):
    """Records the shape of every float32 tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("arch", ["qwen3_17b", "qwen2_vl_7b"])
def test_no_device_makes_a_whole_logits_chunk(arch):
    """On (1, 2) with the head split over ``model`` (tied, untied): no op
    of the step makes an f32 (rows, c, V) tensor; the leaders' CE (no
    ``logits_spec``) makes the whole chunk."""
    cfg = _cfg(arch)
    mesh = _mesh((1, 2))
    whole = (SHAPE.global_batch, SHAPE.seq_len, cfg.vocab)
    for specs, made in ((_specs(mesh), False), ({"act_spec": act_pspec(mesh.axis_names)}, True)):
        state, batch = _state(cfg, mesh), _batch(cfg, 0)
        step = make_train_step(cfg, OPT, mesh=mesh, **specs)
        with _Shapes() as rec:
            step(state, batch)
        assert (whole in rec.shapes) == made


# ---------------------------------------------------------------------------
# what the change is for: the saved residual and the link bytes
# ---------------------------------------------------------------------------
def _loss_and_grads(cfg, mesh, remat=True, **specs):
    """The loss and its gradients on (1, 2) from the seed-0 state: the
    bytes of the distinct storages autograd saves, and each collective
    recorded (op, result bytes, group, members)."""
    state = _state(cfg, mesh)
    batch = _batch(cfg, 0)
    batch = place(batch, batch_pspec(mesh.axis_names, batch), mesh)
    seen, log, inner = {}, [], collectives.record

    def pack(t):
        seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        return t

    def record(*args):
        log.append(args)
        inner(*args)

    collectives.record = record
    try:
        with collectives.tally():
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = mesh_loss_fn(state.params, batch, cfg, mesh, remat=remat, **specs)
            torch.autograd.grad(loss, [b for sh in _leaves(state.params) for b in sh.blocks],
                                allow_unused=True)
    finally:
        collectives.record = inner
    return sum(seen.values()), collections.Counter(log)


def test_saved_bytes_fall_by_the_residual_blocks():
    """qwen3 reduced on (1, 2), remat on, the leaders' CE both ways (no
    ``logits_spec``): with ``act_spec`` the bytes autograd saves fall by
    exactly the residual stream each block keeps on the devices that no
    longer hold it, L (M - 1) rows S d f32."""
    cfg = _cfg("qwen3_17b")
    mesh = _mesh((1, 2))
    M, rows, S = 2, SHAPE.global_batch, SHAPE.seq_len
    before, _ = _loss_and_grads(cfg, mesh)
    after, _ = _loss_and_grads(cfg, mesh, act_spec=act_pspec(mesh.axis_names))
    assert before - after == cfg.n_layers * (M - 1) * rows * S * cfg.d_model * 4


def test_tensor_parallel_all_reduces_become_all_gathers_and_reduce_scatters():
    """qwen3 reduced on (1, 2) without remat (its recompute stops early
    at another collective in the two layouts), the leaders' CE both ways:
    each all-reduce of a (rows, S, d) partial output, forward and
    backward, is replaced by one all-gather of it and one reduce-scatter
    to its blocks, of equal per-device link bytes; the one collective
    added is the gather of the final residual onto the leader (and its
    backward)."""
    cfg = _cfg("qwen3_17b")
    mesh = _mesh((1, 2))
    k, R = 2, SHAPE.global_batch * SHAPE.seq_len * cfg.d_model * 4
    _, before = _loss_and_grads(cfg, mesh, remat=False)
    _, after = _loss_and_grads(cfg, mesh, remat=False, act_spec=act_pspec(mesh.axis_names))
    n = 4 * cfg.n_layers  # attention and MLP, forward and backward
    assert before - after == {("all-reduce", R, k, k): n}
    assert after - before == {("all-gather", R, k, k): n, ("reduce-scatter", R / k, k, k): n + 1,
                              ("all-gather", R, k, 1): 1}
    link = {}
    for op, r, kk, members in (("all-reduce", R, k, k), ("all-gather", R, k, k),
                               ("reduce-scatter", R / k, k, k)):
        t = collectives.Tally()
        t.add(op, r, kk, members)
        link[op] = t.per_device(mesh.size)["link_bytes"]
    assert link["all-reduce"] == link["all-gather"] + link["reduce-scatter"]


# ---------------------------------------------------------------------------
# refusals and the cells
# ---------------------------------------------------------------------------
def test_a_sequence_that_does_not_split_raises():
    cfg = _cfg("qwen3_17b")
    mesh = _mesh((1, 3))
    with pytest.raises(ValueError, match="32 positions .* model axis of 3"):
        _step(cfg, mesh, {"act_spec": act_pspec(mesh.axis_names)})


def test_a_spec_without_a_mesh_raises():
    cfg = _cfg("qwen3_17b")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, OPT, act_spec=act_pspec(("data", "model")))
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, OPT, logits_spec=P("data", None, "model"))
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="mesh"):
        loss_fn(params, _batch(cfg, 0), cfg, act_spec=act_pspec(("data", "model")))


@pytest.mark.parametrize("arch", [a for a in base.ARCH_IDS if a != "elasticity"])
def test_train_cells_carry_the_references_specs(arch, monkeypatch):
    """The train cell of every arch on a (2, 2) mesh: its act_spec and
    logits_spec are what the reference's ``_train_cell`` passes to its
    ``make_train_step`` on a mesh of the same shape."""
    got = {}

    def recording(cfg, opt, **kw):
        got.update(kw)
        return None

    monkeypatch.setattr(ref_cells, "make_train_step", recording)
    mesh = make_local_mesh(2, devices=("meta",) * 4)
    cell = cells.build_cell(arch, "train_4k", mesh)
    ref_cells._train_cell(arch, ref_base.get_config(arch), ref_base.SHAPES["train_4k"],
                          jax.sharding.AbstractMesh((2, 2), ("data", "model")))
    assert tuple(cell.meta["act_spec"]) == tuple(got["act_spec"].spec)
    assert tuple(cell.meta["logits_spec"]) == tuple(got["logits_spec"].spec)


@pytest.mark.parametrize("arch", ["qwen3_17b", "olmoe_1b_7b", "musicgen_medium"])
def test_sequence_parallel_train_cell_traces_on_a_meta_mesh(arch, monkeypatch, tmp_path):
    """A reduced train cell in the tensor-parallel layout (as at full
    size) traced on a meta (2, 2) mesh by the dry-run: it runs and records
    its specs, and against the same cell with a batch-only act_spec its
    all-reduce link bytes fall (the tensor-parallel all-reduces became
    all-gathers and reduce-scatters)."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(cells, "SMALL_MODEL_PARAMS", 0)
    s = base.SHAPES["train_4k"]

    def trace(name):
        rec = dryrun.run_cell(arch, "train_4k", "local", str(tmp_path / name),
                              mesh=make_local_mesh(2, devices=("meta",) * 4), cfg=_cfg(arch),
                              shape_cfg=base.ShapeConfig("train_4k", s.kind, 16, 4))
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory"]["temp_bytes"] > 0
        return rec

    sp = trace("sp")
    assert tuple(sp["meta"]["act_spec"]) == ("data", "model", None)
    monkeypatch.setattr(cells, "act_pspec", lambda axes: P("data", None, None))
    rows = trace("rows")
    assert tuple(rows["meta"]["act_spec"]) == ("data", None, None)
    per_op = [r["collectives"]["per_op"] for r in (sp, rows)]
    assert per_op[0].get("all-reduce", 0) < per_op[1]["all-reduce"]
