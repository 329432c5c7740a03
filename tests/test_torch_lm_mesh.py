"""Training on a mesh of virtual CPU devices against the unsharded port
and the reference (``train_loop(mesh=)``, ``make_train_step(mesh=)``).

Reduced configurations in float32 on one PyTorch thread (with several
intra-op threads one loss in a few runs differs by an ulp, also without a
mesh).  Tolerances:

* a (1, 1) mesh: bitwise the unsharded step (the same operations);
* (2, 1), (1, 2) and (2, 2): loss and grad norm to 1e-5 relative, each
  AdamW moment leaf to 1e-5 of its max |unsharded| after a step -- tensor
  parallelism sums a projection's halves, and the data rows' gradients
  are summed, in another order than one product;
* a given mesh: bitwise repeatable;
* three steps on (2, 2) against the reference's, by the rules of
  ``tests/test_torch_train.py::test_three_train_steps_match_reference``
  (1e-4, every element of qwen3-1.7b's parameters);
* the MoE's expert ids: equal to the unsharded run's;
* a checkpoint taken on (2, 2), restored onto the (1, 2) mesh that
  ``elastic_remesh`` builds after ``simulate_failures``: bitwise equal to
  an undisturbed (1, 2) run from the same state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.configs import base
from repro_torch.convert import train_state
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed.compression import int8_compress, int8_decompress
from repro_torch.distributed.elastic import elastic_remesh, reshard_state, simulate_failures
from repro_torch.distributed.sharding import (
    _lm_items,
    gather,
    lm_layout_mismatches,
    param_pspecs,
    place,
    state_pspecs,
)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train_loop
from repro_torch.models import moe
from repro_torch.models.transformer import _leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import (
    TrainState,
    _requires_grad,
    make_train_step,
    train_state_init,
)

TOL = 1e-5
SHAPE = base.ShapeConfig("t", "train", 32, 4)
OPT = AdamWConfig(total_steps=3, warmup_steps=1)
# dense GQA, expert parallel, and the gathered path (Mamba2 groups with a
# tensor-parallel shared block; xLSTM)
ARCHS = ["qwen3_17b", "olmoe_1b_7b", "zamba2_27b", "xlstm_125m"]
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **change):
    return dataclasses.replace(base.get_reduced(arch), dtype="float32", **change)


def _mesh(dm):
    return make_local_mesh(dm[1], devices=("cpu",) * (dm[0] * dm[1]))


def _batch(cfg, i, shape=SHAPE):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, i).items()}


def _steps(cfg, mesh, n=1, shape=SHAPE, params_tp=True, grad_transform=None):
    """n steps from the seed-0 state; returns (metrics of each step, the
    final state gathered on the host)."""
    state = train_state_init(torch.Generator().manual_seed(0), cfg)
    if mesh is not None:
        specs = state_pspecs(state, mesh, params_tp)
        state = reshard_state(state, specs, mesh)
        _requires_grad(state.params)
        assert lm_layout_mismatches(state, mesh, specs) == []
    step = make_train_step(cfg, OPT, mesh=mesh, grad_transform=grad_transform)
    ms = []
    for i in range(n):
        state, m = step(state, _batch(cfg, i, shape))
        ms.append({k: v.detach().clone() for k, v in m.items()})
    return ms, (gather(state, "cpu") if mesh is not None else state)


_UNSHARDED: dict = {}


def _unsharded(arch):
    if arch not in _UNSHARDED:
        _UNSHARDED[arch] = _steps(_cfg(arch), None)
    return _UNSHARDED[arch]


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _bitwise(a, b):
    return all(torch.equal(x.detach(), y.detach()) for x, y in
               zip(_leaves([a.params, a.opt_state]), _leaves([b.params, b.opt_state])))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_the_unsharded_step_bitwise(arch):
    (rm,), rs = _unsharded(arch)
    (m,), s = _steps(_cfg(arch), _mesh((1, 1)))
    assert all(torch.equal(m[k], rm[k]) for k in rm)
    assert _bitwise(s, rs)


@pytest.mark.parametrize("dm", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_the_unsharded_step_and_repeats_bitwise(arch, dm):
    (rm,), rs = _unsharded(arch)
    (m,), s = _steps(_cfg(arch), _mesh(dm))
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(m[k], rm[k]) <= TOL, (k, float(m[k]), float(rm[k]))
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(_lm_items(s.opt_state[name]),
                                     _lm_items(rs.opt_state[name])):
            assert _rel(a, b) <= TOL, (name, path, _rel(a, b))
    (m2,), s2 = _steps(_cfg(arch), _mesh(dm))
    assert all(torch.equal(m[k], m2[k]) for k in m) and _bitwise(s, s2)


@pytest.mark.parametrize("arch", ["qwen3_17b", "olmoe_1b_7b"])
def test_train_loop_on_one_by_one_mesh_is_the_unsharded_loop_bitwise(arch):
    """``train_loop(mesh=)`` on a (1, 1) mesh: the same logged losses, grad
    norms and final state, bit for bit, as ``train_loop`` without one."""
    cfg = _cfg(arch)
    opt = AdamWConfig(total_steps=3, warmup_steps=1)
    runs = [train_loop(cfg, SHAPE, steps=3, opt=opt, device="cpu", log_every=1, mesh=mesh)
            for mesh in (None, _mesh((1, 1)))]
    (s0, h0), (s1, h1) = runs
    assert [(h["loss"], h["grad_norm"]) for h in h0] == [(h["loss"], h["grad_norm"]) for h in h1]
    assert _bitwise(gather(s1, "cpu"), s0)


def test_pure_data_parallel_layout_matches_the_unsharded_step():
    """``param_pspecs(tp=False)``: no tensor parallelism; the MoE still
    takes the expert branch, on experts cut from the gathered weights."""
    (rm,), rs = _unsharded("olmoe_1b_7b")
    (m,), s = _steps(_cfg("olmoe_1b_7b"), _mesh((1, 2)), params_tp=False)
    assert _rel(m["loss"], rm["loss"]) <= TOL and _rel(m["grad_norm"], rm["grad_norm"]) <= TOL
    for (path, a), (_, b) in zip(_lm_items(s.opt_state["v"]), _lm_items(rs.opt_state["v"])):
        assert _rel(a, b) <= TOL, path


def test_compression_on_blocks_is_the_unsharded_on_one_device():
    """grad_transform sees each device's block gradients; on (1, 1) those
    are the whole gradients, so the step is the unsharded one bitwise."""
    def int8(tree):
        if isinstance(tree, dict):
            return {k: int8(v) for k, v in tree.items()}
        return int8_decompress(*int8_compress(tree))

    cfg = _cfg("qwen3_17b")
    (rm,), rs = _steps(cfg, None, grad_transform=int8)
    (m,), s = _steps(cfg, _mesh((1, 1)), grad_transform=int8)
    assert torch.equal(m["loss"], rm["loss"]) and _bitwise(s, rs)
    (m2,), _ = _steps(cfg, _mesh((2, 2)), grad_transform=int8)
    assert _rel(m2["grad_norm"], rm["grad_norm"]) <= 1e-2


# ---------------------------------------------------------------------------
# the MoE on a mesh
# ---------------------------------------------------------------------------
def _routes(cfg, mesh, shape=SHAPE):
    """Every MoE call's expert ids in one step's forward (the recompute's
    too): a list a call, each a list a device."""
    kept, inner = [], moe.route

    def keeping(params, x, cfg):
        out = inner(params, x, cfg)
        kept.append(out[2].clone())
        return out

    moe.route = keeping
    try:
        ms, _ = _steps(cfg, mesh, shape=shape)
    finally:
        moe.route = inner
    return ms[0], kept


@pytest.mark.parametrize("dm,S,branch", [((2, 2), 32, "expert"), ((1, 3), 48, "capacity"),
                                         ((1, 3), 32, None)],
                         ids=["expert-2x2", "capacity-1x3", "none-1x3"])
def test_moe_branches_route_as_the_unsharded_run(dm, S, branch):
    """Reduced olmoe (8 experts, top 2): expert parallel on a model axis of
    2; on 3, which does not divide the experts, the capacity axis (15
    slots at S = 48) or nothing (10 slots at S = 32).  Each device routes
    its data row's tokens, so the ids of a data row's first model device,
    concatenated over the rows, are the unsharded run's."""
    cfg = _cfg("olmoe_1b_7b")
    shape = base.ShapeConfig("t", "train", S, 4)
    mesh = _mesh(dm)
    assert moe.moe_branch(cfg, S, dm[1]) == branch
    rm, ref_ids = _routes(cfg, None, shape)
    m, ids = _routes(cfg, mesh, shape)
    assert _rel(m["loss"], rm["loss"]) <= TOL and _rel(m["grad_norm"], rm["grad_norm"]) <= TOL
    per_call = len(ids) // len(ref_ids)
    assert per_call == mesh.size
    for c, want in enumerate(ref_ids):
        got = ids[c * per_call:(c + 1) * per_call]
        assert torch.equal(torch.cat([got[k] for k in mesh.leaders()]), want)
        for k in range(mesh.size):  # the model devices of a row route alike
            assert torch.equal(got[k], got[mesh.leaders()[k // dm[1]]])


def test_moe_aux_loss_is_global_over_the_data_rows():
    """The aux of two data rows equals the unsharded aux of the whole
    batch, and not the mean of the rows' own aux losses."""
    cfg = _cfg("olmoe_1b_7b")
    g = torch.Generator().manual_seed(3)
    p = moe.moe_init(g, cfg, torch.float32)
    x = torch.randn(4, 16, cfg.d_model, generator=g)
    _, aux = moe.moe_apply(p, x, cfg)
    mesh = _mesh((2, 1))
    sh = place({"moe": p}, param_pspecs({"moe": p}, mesh), mesh)["moe"]
    ys, got = moe.moe_mesh_apply(sh, [x[:2], x[2:]], cfg, mesh)
    rows = (moe.moe_apply(p, x[:2], cfg)[1] + moe.moe_apply(p, x[2:], cfg)[1]) / 2
    assert _rel(got, aux) <= 1e-6 and _rel(rows, aux) > 1e-4
    assert _rel(torch.cat(ys), moe.moe_apply(p, x, cfg)[0]) <= 1e-6


# ---------------------------------------------------------------------------
# against the reference, and the elastic restart
# ---------------------------------------------------------------------------
def test_three_mesh_steps_match_reference():
    """qwen3-1.7b reduced on (2, 2) from the reference's initial state:
    each step's loss, grad norm and lr, the final moments and every
    element of the final parameters to 1e-4 (of max |reference| a leaf)."""
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
    step = make_train_step(cfg, OPT, mesh=mesh)
    for i in range(3):
        batch = make_batch(cfg, SHAPE, i)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(rm[k])) <= rel * abs(float(rm[k])), k
    assert int(state.step) == int(rstate.step) == 3
    got = gather(state, "cpu")
    ref = jax.tree.map(np.asarray, rstate)
    for tree, rtree in ((got.params, ref.params), (got.opt_state["m"], ref.opt_state["m"]),
                        (got.opt_state["v"], ref.opt_state["v"])):
        flat, _ = jax.tree_util.tree_flatten_with_path(rtree)
        want = {jax.tree_util.keystr(kp): leaf for kp, leaf in flat}
        for path, a in _lm_items(tree):
            assert _rel(a, torch.from_numpy(np.asarray(want[path], np.float32))) <= rel, path


def test_elastic_restart_from_a_mesh_checkpoint_is_bitwise(tmp_path):
    """Three steps on (2, 2) with a checkpoint; two of the four devices
    fail; ``elastic_remesh`` gives (1, 2); ``train_loop`` resumes from the
    checkpoint onto it.  Bitwise equal to the (2, 2) state resharded in
    memory onto (1, 2) and stepped there; the checkpoint's leaves are the
    unsharded state's paths and format."""
    cfg = _cfg("qwen3_17b")
    opt = AdamWConfig(total_steps=6, warmup_steps=1)
    m22 = _mesh((2, 2))
    s22, _ = train_loop(cfg, SHAPE, steps=3, ckpt_dir=str(tmp_path), opt=opt, device="cpu",
                        mesh=m22, log_every=1)
    m12 = elastic_remesh(simulate_failures(list(m22.flat), 2), model_parallel=2)
    assert m12.shape == {"data": 1, "model": 2}
    restarted, hist = train_loop(cfg, SHAPE, steps=5, ckpt_dir=str(tmp_path), opt=opt,
                                 device="cpu", mesh=m12, log_every=1)
    undisturbed = reshard_state(s22, state_pspecs(s22, m12), m12)
    _requires_grad(undisturbed.params)
    step = make_train_step(cfg, opt, mesh=m12)
    losses = []
    for i in (3, 4):
        undisturbed, m = step(undisturbed, _batch(cfg, i))
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in hist] == losses
    assert _bitwise(gather(restarted, "cpu"), gather(undisturbed, "cpu"))
    unsharded = train_state_init(torch.Generator().manual_seed(0), cfg)
    assert ([p for p, _ in _flatten_with_paths(gather(s22, "cpu"))]
            == [p for p, _ in _flatten_with_paths(unsharded)])
    assert isinstance(restarted, TrainState)
