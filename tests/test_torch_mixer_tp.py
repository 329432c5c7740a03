"""Tensor parallelism by heads of the Mamba2 (zamba2) and xLSTM mixers in
the mesh train step, against the unsharded step and the reference.

Reduced configurations in float32 on virtual CPU devices, one PyTorch
thread (as ``tests/test_torch_seq_parallel.py``): zamba2 (8 Mamba2 heads)
and xlstm (2 heads, one mLSTM and one sLSTM block).  Tolerances:

* (1, 2) and (2, 2), zamba2 also with ``act_pspec`` and ``P(dp, None,
  "model")``: loss and grad norm to 1e-5 relative of the unsharded step,
  each AdamW moment leaf to 1e-5 of its max |unsharded|; a given mesh
  bitwise repeatable; the mixers ran on H / M heads a device;
* (1, 1): the unsharded step bitwise; xlstm on (1, 4), whose 2 heads do
  not split over 4: the gathered-whole mixers, to 1e-5;
* three (2, 2) steps of each against the reference by the rules of
  ``test_three_mesh_steps_match_reference`` (1e-4);
* the cross-device RMSNorm alone against ``common.rmsnorm``: value and
  its gradients to 1e-6 relative (of max |.|);
* each device's fetch of its mixer weights (``collectives.tally``'s
  records) and a meta train cell's Mamba2 dot FLOPs a device: exact.
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
    mesh_rmsnorm,
    place,
    state_pspecs,
)
from repro_torch.launch import cells, jaxpr_cost
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.common import rmsnorm
from repro_torch.models.transformer import _leaves, mesh_loss_fn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import _requires_grad, make_train_step, train_state_init

TOL = 1e-5
SHAPE = base.ShapeConfig("t", "train", 32, 4)
OPT = AdamWConfig(total_steps=3, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tp_calls(monkeypatch):
    """The model device counts of every mixer that ran tensor parallel."""
    seen, inner = [], tf._mixer_tp_views

    def counting(p, mesh, ranges):
        seen.append(mesh.shape["model"])
        return inner(p, mesh, ranges)

    monkeypatch.setattr(tf, "_mixer_tp_views", counting)
    return seen


def _cfg(arch):
    return dataclasses.replace(base.get_reduced(arch), dtype="float32")


def _mesh(dm, device="cpu"):
    return make_local_mesh(dm[1], devices=(device,) * (dm[0] * dm[1]))


def _specs(mesh):
    return {"act_spec": act_pspec(mesh.axis_names), "logits_spec": P("data", None, "model")}


def _batch(cfg, i):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, SHAPE, i).items()}


def _state(cfg, mesh):
    state = train_state_init(torch.Generator().manual_seed(0), cfg)
    if mesh is not None:
        state = reshard_state(state, state_pspecs(state, mesh), mesh)
        _requires_grad(state.params)
    return state


def _step(cfg, mesh, specs=None):
    """One step from the seed-0 state: (metrics, the state gathered on the
    host)."""
    step = make_train_step(cfg, OPT, mesh=mesh, **(specs or {}))
    state, m = step(_state(cfg, mesh), _batch(cfg, 0))
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


def _close_to_unsharded(arch, m, s):
    rm, rs = _unsharded(arch)
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(m[k], rm[k]) <= TOL, (k, float(m[k]), float(rm[k]))
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(_lm_items(s.opt_state[name]),
                                     _lm_items(rs.opt_state[name])):
            assert _rel(a, b) <= TOL, (name, path, _rel(a, b))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dm,specs", [
    ("zamba2_27b", (1, 2), False), ("zamba2_27b", (2, 2), False),
    ("zamba2_27b", (1, 2), True), ("zamba2_27b", (2, 2), True),
    ("xlstm_125m", (1, 2), False), ("xlstm_125m", (2, 2), False)],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_tensor_parallel_mixers_match_the_unsharded_step_and_repeat(arch, dm, specs, tp_calls):
    mesh = _mesh(dm)
    sp = _specs(mesh) if specs else None
    m, s = _step(_cfg(arch), mesh, sp)
    # zamba2: 4 Mamba2 layers; xlstm: an mLSTM and an sLSTM block (the
    # mLSTM's recompute under remat runs it again)
    assert tp_calls and set(tp_calls) == {dm[1]}
    assert len(tp_calls) == {"zamba2_27b": 3 * 4, "xlstm_125m": 2 + 1}[arch]
    _close_to_unsharded(arch, m, s)
    m2, s2 = _step(_cfg(arch), mesh, sp)
    assert _same_metrics(m2, m) and _bitwise(s2, s)


@pytest.mark.parametrize("arch", ["zamba2_27b", "xlstm_125m"])
def test_one_by_one_mesh_is_the_unsharded_step_bitwise(arch, tp_calls):
    rm, rs = _unsharded(arch)
    mesh = _mesh((1, 1))
    m, s = _step(_cfg(arch), mesh, _specs(mesh))
    assert _same_metrics(m, rm) and _bitwise(s, rs)
    assert not tp_calls


def test_heads_that_do_not_split_fall_back_to_the_gathered_mixers(tp_calls):
    """xlstm's 2 heads on a model axis of 4: the mixers gathered whole."""
    m, s = _step(_cfg("xlstm_125m"), _mesh((1, 4)))
    assert not tp_calls
    _close_to_unsharded("xlstm_125m", m, s)


def _by_path(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): np.array(leaf, np.float32) for kp, leaf in flat}


@pytest.mark.parametrize("arch", ["zamba2_27b", "xlstm_125m"])
def test_three_tensor_parallel_steps_match_reference(arch):
    """Each arch reduced on (2, 2) (zamba2 with both specs) from the
    reference's initial state: each step's loss, grad norm and lr and the
    final moments to 1e-4 (of max |reference| a leaf); the final
    parameters to 1e-4 on the elements whose gradient is not rounding noise,
    as ``tests/test_torch_train.py::test_three_train_steps_match_reference``
    holds these architectures unsharded (an element whose clipped gradient,
    recovered from the reference's first moment at each step, is 0 or above
    100 eps)."""
    rel = 1e-4
    cfg = _cfg(arch)
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    rstate = ref_trainer.train_state_init(jax.random.PRNGKey(0), rcfg)
    mesh = _mesh((2, 2))
    state = train_state(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    state = reshard_state(state, state_pspecs(state, mesh), mesh)
    _requires_grad(state.params)
    rstep = jax.jit(ref_trainer.make_train_step(rcfg, ref_adamw.AdamWConfig(
        **dataclasses.asdict(OPT))))
    step = make_train_step(cfg, OPT, mesh=mesh, **(_specs(mesh) if arch == "zamba2_27b" else {}))
    noise: dict = {}
    for i in range(3):
        batch = make_batch(cfg, SHAPE, i)
        m_before = _by_path(rstate.opt_state["m"])
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(rm[k])) <= rel * abs(float(rm[k])), k
        for path, m_after in _by_path(rstate.opt_state["m"]).items():
            g = (m_after - OPT.beta1 * m_before[path]) / (1 - OPT.beta1)
            noise[path] = noise.get(path, False) | ((np.abs(g) <= 100 * OPT.eps) & (g != 0))
    got = gather(state, "cpu")
    ref = jax.tree.map(np.asarray, rstate)
    for name in ("m", "v"):
        want = _by_path(ref.opt_state[name])
        for path, a in _lm_items(got.opt_state[name]):
            assert _rel(a, torch.from_numpy(want[path])) <= rel, (name, path)
    want = _by_path(ref.params)
    for path, a in _lm_items(got.params):
        keep = ~noise[path]
        err = float(np.abs(a.detach().numpy() - want[path])[keep].max(initial=0.0))
        assert err <= rel * float(np.abs(want[path]).max()), (path, err, float(keep.mean()))


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dm", [(1, 2), (2, 2), (1, 4)], ids=lambda d: f"{d[0]}x{d[1]}")
def test_cross_device_rmsnorm_matches_rmsnorm(dm):
    """Each device's block of channels of its data row's rows, normed over
    the whole width: the value and the gradients with respect to the
    input and the scale, against ``common.rmsnorm`` on the whole."""
    mesh = _mesh(dm)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, 32, generator=g, requires_grad=True)
    scale = (1.0 + 0.1 * torch.randn(32, generator=g)).requires_grad_(True)
    rows = x.shape[0] // dm[0]
    xs = [mesh_block(x[rows * mesh.coords(k)["data"]:][:rows], mesh, k, 2)
          for k in range(mesh.size)]
    got = mesh_rmsnorm(xs, [mesh_block(scale, mesh, k, 0) for k in range(mesh.size)], mesh,
                       1e-6)
    want = rmsnorm(x, scale, 1e-6)
    for k, y in enumerate(got):
        w = mesh_block(want[rows * mesh.coords(k)["data"]:][:rows], mesh, k, 2)
        assert _rel(y, w) <= 1e-6
    # a random cotangent; the devices' blocks cover the whole once
    c = torch.randn(want.shape, generator=g)
    total = sum((y * mesh_block(c[rows * mesh.coords(k)["data"]:][:rows], mesh, k, 2)).sum()
                for k, y in enumerate(got))
    gw = torch.autograd.grad((want * c).sum(), (x, scale))
    gg = torch.autograd.grad(total, (x, scale))
    for a, b in zip(gg, gw):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("arch,want", [
    # zamba2 (d = 64, d_in = 128, N = 16, H = 8): each device's in_proj
    # columns are its 64 of z, its 64 of x, all 32 of B and C and its 4 of
    # dt, 164 of 296 columns, x 64 rows x 4 bytes, for each of 4 layers;
    # out_proj's rows, the conv and the heads' vectors are each device's own
    ("zamba2_27b", [64 * 164 * 4] * 2 * 4),
    # xlstm (d = 64, d_in = 128, H = 2): the mLSTM's w_up columns are all
    # 128 of xb and its 64 of z (192 of 256); the sLSTM's w_in columns its
    # head's 32 of each of the four gates (128 of 256)
    ("xlstm_125m", [64 * 192 * 4] * 2 + [64 * 128 * 4] * 2)])
def test_each_device_fetches_its_head_columns(arch, want, monkeypatch):
    """On (1, 2), a forward without grad: the all-gathers recorded are the
    embedding's (to both model devices), the head's (to the leader) and one
    fetch a device a mixer of exactly its head columns."""
    cfg = _cfg(arch)
    mesh = _mesh((1, 2))
    state = _state(cfg, mesh)
    batch = _batch(cfg, 0)
    batch = place(batch, batch_pspec(mesh.axis_names, batch), mesh)
    log, inner = [], collectives.record

    def record(op, r, k, members):
        log.append((op, r, members))
        inner(op, r, k, members)

    monkeypatch.setattr(collectives, "record", record)
    with collectives.tally(), torch.no_grad():
        mesh_loss_fn(state.params, batch, cfg, mesh)
    whole = cfg.vocab * cfg.d_model * 4
    gathers = sorted(r for op, r, _ in log if op == "all-gather")
    assert gathers == sorted(want + [whole, whole])
    assert [m for op, r, m in log if op == "all-gather" and r != whole] == [1] * len(want)


_MAMBA_BLOCK = tf._mesh_mamba_block


def _mamba_dot_flops(mesh, monkeypatch):
    """The dot FLOPs of the Mamba2 block calls that the reduced zamba2
    train cell (the tensor-parallel layout) traced on ``mesh`` of meta
    devices runs to their end (a recompute under remat stops early), and
    their number, and the cell's account of its mixers."""
    counted, inner = [], _MAMBA_BLOCK

    def counting(*args):
        with jaxpr_cost.CostMode() as mode:
            out = inner(*args)
        counted.append(mode.cost.dot_flops)
        return out

    monkeypatch.setattr(tf, "_mesh_mamba_block", counting)
    monkeypatch.setattr(cells, "SMALL_MODEL_PARAMS", 0)
    s = base.SHAPES["train_4k"]
    cell = cells.build_cell("zamba2_27b", "train_4k", mesh, cfg=_cfg("zamba2_27b"),
                            shape=base.ShapeConfig("train_4k", s.kind, 32, 4))
    cell.run()
    return sum(counted), len(counted), cell.meta["mixers"]


def test_train_cell_mamba_dot_flops_a_device_halve_but_for_b_and_c(monkeypatch):
    """The reduced zamba2 train cell on a meta (1, 2) mesh against (1, 1):
    a device's Mamba2 dot FLOPs in one block call (B = 4, S = 32, d = 64,
    d_in = 128, N = 16, H = 8, P = 16, chunk Q = 16; T = B S tokens) are
    half of the whole block's plus half of what every device computes
    alike: the B and C columns of in_proj and the (Q, Q) scores C B^T."""
    B, S, d, d_in, N, H, P, Q = 4, 32, 64, 128, 16, 8, 16, 16
    T = B * S
    in_proj = 2 * T * d * (2 * d_in + 2 * N + H)
    scores = 2 * B * S * Q * N
    heads = 2 * B * S * H * Q * P + 2 * 2 * B * S * H * N * P  # y, states, C s_in
    out_proj = 2 * T * d_in * d
    whole = in_proj + scores + heads + out_proj
    shared = 2 * T * d * 2 * N + scores
    assert whole == 8_585_216 and shared == 589_824
    one, calls, said = _mamba_dot_flops(_mesh((1, 1), "meta"), monkeypatch)
    assert said == "gathered whole on each device (8 heads on a model axis of 1)"
    two, calls2, said = _mamba_dot_flops(_mesh((1, 2), "meta"), monkeypatch)
    assert said == "tensor parallel by heads over 'model': 4 of 8 heads a device"
    assert calls == calls2 > 0
    assert one == calls * whole
    assert two / 2 == calls * (whole // 2 + shared // 2) == calls * 4_587_520
