"""GPipe over a device list (``repro_torch.distributed.pipeline``) on the
CPU: the schedule's helpers as the reference's ``tests/test_distributed.py``
cases; ``pipeline_apply`` on 2 and 4 stages of virtual CPU devices bitwise
equal to the sequential apply of its stages, forward and gradient (the
stages' output buffers, zeros but the last's, are summed in order, adding
exact zeros); on one stage equal to the reference's ``pipeline_apply`` on
its one device, to 1e-6 of max |reference| (float32 products in XLA's and
PyTorch's orders)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import pipeline as ref_pipeline
from repro_torch.configs import base
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply, split_stages
from repro_torch.distributed.sharding import LMMesh
from repro_torch.models.transformer import _block_x, _positions, _unstack, init_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_split_stages_shapes():
    sp = split_stages({"w": torch.zeros((8, 3, 3))}, 4)
    assert sp["w"].shape == (4, 2, 3, 3)


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)


def _stage_mesh(n):
    devs = np.empty(n, dtype=object)
    devs[:] = ["cpu"] * n
    return LMMesh(devs.reshape(n, 1, 1), ("pod", "data", "model"))


def _mlp_stage(p, x):
    for i in range(p["w1"].shape[0]):
        x = x + torch.tanh(x @ p["w1"][i]) @ p["w2"][i]
    return x


def _slice(tree, s):
    if isinstance(tree, dict):
        return {k: _slice(v, s) for k, v in tree.items()}
    return tree[s]


def _sequential(stage_fn, stage_params, x, n_micro):
    """Each microbatch through the stages in order, the stage's slice of
    ``stage_params`` a stage (the leaves' leading axis)."""
    leaf = stage_params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    n_stages = leaf.shape[0]
    outs = []
    for xm in x.reshape((n_micro, -1) + tuple(x.shape[1:])):
        for s in range(n_stages):
            xm = stage_fn(_slice(stage_params, s), xm)
        outs.append(xm)
    return torch.stack(outs).reshape(x.shape)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8), (4, 2)])
def test_pipeline_is_the_sequential_apply_bitwise_forward_and_gradient(n_stages, n_micro):
    g = torch.Generator().manual_seed(0)
    L, d = 8, 16
    params = {"w1": (torch.randn(L, d, d, generator=g) / 4).requires_grad_(True),
              "w2": (torch.randn(L, d, d, generator=g) / 4).requires_grad_(True)}
    x = torch.randn(8, 5, d, generator=g, requires_grad=True)
    leaves = [params["w1"], params["w2"], x]
    got = pipeline_apply(_mlp_stage, split_stages(params, n_stages), x,
                         mesh=_stage_mesh(n_stages), n_micro=n_micro)
    want = _sequential(_mlp_stage, split_stages(params, n_stages), x, n_micro)
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=g)
    for a, b in zip(torch.autograd.grad(got, leaves, cot), torch.autograd.grad(want, leaves, cot)):
        assert torch.equal(a, b)


def test_pipeline_of_transformer_blocks_is_the_sequential_apply_bitwise():
    """qwen3-1.7b reduced, its 2 blocks as 2 stages of 1 (chip_smoke.py's
    28 as 4 of 7), 4 microbatches."""
    cfg = dataclasses.replace(base.get_reduced("qwen3_17b"), dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(1))
    x = params["embed"][tokens].detach()
    pos = _positions({"tokens": tokens[:1]}, cfg)

    def stage(p, xm):
        for layer in _unstack(p, p["attn_norm"].shape[0]):
            xm = _block_x(layer, xm, cfg, pos)[0]
        return xm

    staged = split_stages(params["blocks"], 2)
    with torch.no_grad():
        got = pipeline_apply(stage, staged, x, mesh=_stage_mesh(2), n_micro=4)
        want = _sequential(stage, staged, x, 4)
    assert torch.equal(got, want)


def test_one_stage_is_the_references_pipeline_apply():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((1, 3, 8, 8)).astype(np.float32) / 4
    x = rng.standard_normal((6, 8)).astype(np.float32)

    def ref_stage(p, xm):
        for i in range(p.shape[0]):
            xm = jnp.tanh(xm @ p[i])
        return xm

    def stage(p, xm):
        for i in range(p.shape[0]):
            xm = torch.tanh(xm @ p[i])
        return xm

    ref_mesh = jax.make_mesh((1,), ("pod",))
    want = np.asarray(ref_pipeline.pipeline_apply(ref_stage, jnp.asarray(w), jnp.asarray(x),
                                                  mesh=ref_mesh, n_micro=3))
    got = pipeline_apply(stage, torch.from_numpy(w), torch.from_numpy(x), mesh=_stage_mesh(1),
                         n_micro=3).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
