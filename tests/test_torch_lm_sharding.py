"""The LM half of the port's sharding against the reference, on the CPU.

* ``param_pspecs``, ``state_pspecs``, ``batch_pspec``, ``act_pspec`` and
  ``decode_state_pspecs`` equal the reference's, leaf by leaf (by tree path
  as ``jax.tree_util.keystr`` prints it), for every LM architecture at its
  full configuration, on both production mesh shapes, with ``tp`` on and
  off.  Both sides work on shapes: ``jax.eval_shape`` of the reference's
  initializers, the port's ``param_shapes`` and ``init_decode_state`` on
  the meta device.
* ``elastic_remesh`` as the reference's ``tests/test_distributed.py``
  cases, on virtual CPU devices.
* ``place``/``gather`` round trips are bitwise, and each device's block
  covers the index range jax's ``NamedSharding`` gives that mesh device
  (read from its HLO tile assignment on an abstract mesh).
* The collectives: each forward against its definition, each backward
  the dual collective, sums in member order.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_reduced as ref_get_reduced
from repro.data import pipeline as ref_pipeline
from repro.distributed import sharding as ref_sharding
from repro.models import transformer as ref_tf
from repro.train import trainer as ref_trainer
from repro_torch.configs import base
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import collectives
from repro_torch.distributed.elastic import elastic_remesh, reshard_state, simulate_failures
from repro_torch.distributed.sharding import (
    P,
    LMMesh,
    Sharded,
    _lm_items,
    act_pspec,
    batch_pspec,
    decode_state_pspecs,
    gather,
    lm_layout_mismatches,
    local_views,
    param_pspecs,
    place,
    state_pspecs,
)
from repro_torch.launch.mesh import MESH_AXES, make_local_mesh
from repro_torch.models.transformer import init_decode_state, param_shapes
from repro_torch.train.trainer import TrainState

MESH_SINGLE = {"data": 16, "model": 16}
MESH_MULTI = {"pod": 2, "data": 16, "model": 16}
MESHES = [pytest.param(MESH_SINGLE, id="single"), pytest.param(MESH_MULTI, id="multi")]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def _ref_state_shapes(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda k: ref_trainer.train_state_init(k, cfg), jax.random.PRNGKey(0))


def _ref_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(kp): leaf for kp, leaf in flat}


def _port_state_shapes(cfg):
    shapes = param_shapes(cfg)
    return TrainState(params=shapes, opt_state={"m": shapes, "v": shapes, "step": ()}, step=())


def _assert_same_specs(port, ref):
    got = {path: tuple(spec) for path, spec in _lm_items(port)}
    want = {path: tuple(spec) for path, spec in _ref_items(ref).items()}
    assert got == want


@pytest.mark.parametrize("tp", [True, False])
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", base.PORTED)
def test_param_and_state_pspecs_are_the_references(arch, mesh_shape, tp):
    """Every leaf's spec, at the full configuration, by path."""
    ref_state = _ref_state_shapes(arch)
    cfg = base.get_config(arch)
    mesh = _FakeMesh(mesh_shape)
    _assert_same_specs(param_pspecs(param_shapes(cfg), mesh, tp),
                       ref_sharding.param_pspecs(ref_state.params, mesh, tp))
    _assert_same_specs(state_pspecs(_port_state_shapes(cfg), mesh, tp),
                       ref_sharding.state_pspecs(ref_state, mesh, tp))


@pytest.mark.parametrize("arch", ["qwen3_17b", "olmoe_1b_7b", "xlstm_125m"])
def test_param_pspecs_without_a_mesh_are_the_references(arch):
    ref_state = _ref_state_shapes(arch)
    _assert_same_specs(param_pspecs(param_shapes(base.get_config(arch))),
                       ref_sharding.param_pspecs(ref_state.params))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["qwen3_17b", "qwen2_vl_7b", "musicgen_medium"])
def test_batch_and_act_pspecs_are_the_references(arch, multi_pod):
    axes = MESH_AXES[multi_pod]
    cfg = base.get_reduced(arch)
    shape = base.ShapeConfig("t", "train", 64, 4)
    batch = make_batch(cfg, shape, 0)
    ref_batch = ref_pipeline.make_batch(ref_get_reduced(arch), shape, 0)
    _assert_same_specs(batch_pspec(axes, batch), ref_sharding.batch_pspec(axes, ref_batch))
    assert tuple(act_pspec(axes)) == tuple(ref_sharding.act_pspec(axes))


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", base.PORTED)
def test_decode_state_pspecs_are_the_references(arch, mesh_shape):
    """decode_32k's batch of 128 and 32,768 positions, on shapes only."""
    B, S = 128, 32_768
    cfg = base.get_config(arch)
    axes = tuple(mesh_shape)
    mesh = _FakeMesh(mesh_shape)
    rcfg = ref_get_config(arch)
    ref_state = jax.eval_shape(lambda: ref_tf.init_decode_state(rcfg, B, S))
    port_state = init_decode_state(cfg, B, S, device="meta")
    _assert_same_specs(decode_state_pspecs(port_state, axes, cfg, mesh),
                       ref_sharding.decode_state_pspecs(ref_state, axes, rcfg, mesh))


def test_spec_type_normalizes_as_jax():
    for parts in [(("data",), "model", None), ((), None), (("pod", "data"), None), ()]:
        assert tuple(P(*parts)) == tuple(JP(*parts))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_elastic_remesh_drops_stragglers():
    alive = simulate_failures(["cpu"] * 64, 3)  # 61 left
    mesh = elastic_remesh(alive, model_parallel=16)
    assert mesh.shape["model"] == 16
    assert mesh.shape["data"] == 3  # 48 devices used, 13 dropped
    assert mesh.size == 48


def test_elastic_remesh_shrinks_tp_last():
    mesh = elastic_remesh(["cpu"] * 8, model_parallel=16)
    assert mesh.shape["model"] == 8
    assert mesh.shape["data"] == 1


def test_make_local_mesh_halves_the_model_axis_until_it_divides():
    assert make_local_mesh(2, devices=("cpu",) * 4).shape == {"data": 2, "model": 2}
    assert make_local_mesh(3, devices=("cpu",) * 4).shape == {"data": 4, "model": 1}
    assert make_local_mesh(devices=("cpu",) * 2).shape == {"data": 2, "model": 1}


def test_a_mesh_naming_a_card_the_host_lacks_raises():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"the host has {n} CUDA card"):
        make_local_mesh(2, devices=(f"cuda:{n}",) * 4)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
LAYOUTS = [
    ((2, 2), ("data", "model"), ("data", "model"), (8, 6)),
    ((2, 2), ("data", "model"), ("model", None), (4, 3)),
    ((2, 2), ("data", "model"), (None, None), (4, 3)),
    ((2, 2, 3), ("pod", "data", "model"), (("pod", "data"), "model"), (8, 9)),
    ((2, 2, 3), ("pod", "data", "model"), (None, "model", ("data", "pod")), (2, 6, 4)),
    ((1, 4), ("data", "model"), ("data", "model"), (3, 8)),
]


def _jax_ranges(sizes, names, spec, shape):
    """Each mesh device's (start, stop) a dim under jax's NamedSharding,
    read from the HLO tile assignment of an abstract mesh."""
    sh = NamedSharding(AbstractMesh(sizes, names), JP(*spec))
    hlo = sh._to_xla_hlo_sharding(len(shape))
    n = int(np.prod(sizes))
    if hlo.is_replicated():
        return {k: tuple((0, s) for s in shape) for k in range(n)}
    block = sh.shard_shape(shape)
    dims = hlo.tile_assignment_dimensions()
    out = {}
    for pos, dev in enumerate(hlo.tile_assignment_devices()):
        tile = np.unravel_index(pos, dims)[:len(shape)]
        out[dev] = tuple((int(t) * b, (int(t) + 1) * b) for t, b in zip(tile, block))
    return out


@pytest.mark.parametrize("sizes,names,spec,shape", LAYOUTS)
def test_place_gives_jax_block_ranges_and_gather_is_bitwise(sizes, names, spec, shape):
    mesh = LMMesh(np.array(["cpu"] * int(np.prod(sizes)), dtype=object).reshape(sizes), names)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float64).reshape(shape)
    sh = place({"w": x}, {"w": P(*spec)}, mesh)["w"]
    assert isinstance(sh, Sharded) and lm_layout_mismatches({"w": sh}, mesh) == []
    ranges = _jax_ranges(sizes, names, spec, shape)
    for k, b in enumerate(sh.blocks):
        assert torch.equal(b, x[tuple(slice(lo, hi) for lo, hi in ranges[k])]), (k, ranges[k])
    assert torch.equal(gather({"w": sh})["w"], x)
    # replicas are tensors of their own
    assert len({b.data_ptr() for b in sh.blocks}) == mesh.size


def test_reshard_between_meshes_and_layout_mismatches():
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
    m22 = make_local_mesh(2, devices=("cpu",) * 4)
    m12 = make_local_mesh(2, devices=("cpu",) * 2)
    a = place({"w": x, "step": torch.tensor(3)}, {"w": P("data", "model"), "step": P()}, m22)
    b = reshard_state(a, {"w": P(None, "model"), "step": P()}, m12)
    assert torch.equal(gather(b)["w"], x) and int(b["step"]) == 3
    assert lm_layout_mismatches(b, m12) == []
    assert lm_layout_mismatches(a, m12) and lm_layout_mismatches({"w": x}, m12)
    assert lm_layout_mismatches(b, m12, {"w": P("data", "model"), "step": P()})


def test_local_views_keep_the_model_blocks_and_gather_the_rest():
    mesh = make_local_mesh(2, devices=("cpu",) * 4)
    x = torch.arange(48.0).reshape(8, 6)
    sh = place({"w": x}, {"w": P("data", "model")}, mesh)["w"]
    for k, v in enumerate(local_views(sh, ("model",))):
        j = mesh.coords(k)["model"]
        assert torch.equal(v, x[:, 3 * j:3 * (j + 1)])
    assert all(torch.equal(v, x) for v in local_views(sh))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _leaves(n, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(n)]


def _vjp(fn, xs, cots):
    outs = fn(xs)
    return torch.autograd.grad(outs, xs, cots)


@pytest.mark.parametrize("n", [2, 3])
def test_all_gather_and_reduce_scatter_are_each_others_duals(n):
    xs = _leaves(n, (2, 3))
    outs = collectives.all_gather(xs, 1)
    assert all(torch.equal(o, torch.cat(xs, 1)) for o in outs)
    cots = [c.detach() for c in _leaves(n, (2, 3 * n), seed=1)]
    got = _vjp(lambda v: collectives.all_gather(v, 1), xs, cots)
    tot = cots[0]
    for c in cots[1:]:
        tot = tot + c
    assert all(torch.equal(g, p) for g, p in zip(got, tot.chunk(n, 1)))
    ys = _leaves(n, (2, 3 * n), seed=2)
    rs = collectives.reduce_scatter(ys, 1)
    s = ys[0]
    for y in ys[1:]:
        s = s + y
    assert all(torch.equal(r, p) for r, p in zip(rs, s.chunk(n, 1)))
    cots = [c.detach() for c in _leaves(n, (2, 3), seed=3)]
    got = _vjp(lambda v: collectives.reduce_scatter(v, 1), ys, cots)
    assert all(torch.equal(g, torch.cat(cots, 1)) for g in got)


def test_all_reduce_and_ppermute_backward():
    xs = _leaves(3, (4,))
    s = xs[0] + xs[1] + xs[2]
    assert all(torch.equal(o, s) for o in collectives.all_reduce(xs))
    cots = [c.detach() for c in _leaves(3, (4,), seed=1)]
    got = _vjp(collectives.all_reduce, xs, cots)
    assert all(torch.equal(g, cots[0] + cots[1] + cots[2]) for g in got)
    perm = [(0, 1), (1, 2)]
    outs = collectives.ppermute(xs, perm)
    assert torch.equal(outs[0], torch.zeros(4)) and torch.equal(outs[2], xs[1])
    got = torch.autograd.grad(outs[1:], xs[:2], cots[1:])
    assert torch.equal(got[0], cots[1]) and torch.equal(got[1], cots[2])
