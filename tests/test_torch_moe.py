"""The port's mixture of experts (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same numpy-made inputs.

Reduced olmoe-1b-7b (8 experts, top 2, d_model 64, d_ff 64) and
mixtral-8x7b (4 experts, top 2, d_ff 128) in float32, the reference's
parameters carried across.  At ``capacity_factor`` 64 no assignment is
dropped, at 1.25 (the configurations' own) and 0.25 some are.  Tolerances:

* expert ids and the set of dropped assignments: identical;
* y: 1e-5 of max |y|; the aux loss: 1e-6 relative;
* gradients of sum(y * c) + aux (c a fixed numpy cotangent) with respect
  to x and every parameter: 1e-5 of the leaf's max |reference|.

The reference's ids are read from its own ``jax.lax.top_k`` call, the
port's from its ``route``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import moe as ref_moe
from repro_torch.configs import base
from repro_torch.models import moe

B, S = 2, 16


def _cfg(arch, **kw):
    return dataclasses.replace(base.get_reduced(arch), dtype="float32", **kw)


def _ref_cfg(cfg):
    return ref_base.ArchConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    ref = jax.tree.map(np.array, ref_moe.moe_init(jax.random.PRNGKey(seed), _ref_cfg(cfg),
                                                  jnp.float32))
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def _x(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _ref_run(ref, x, cfg, monkeypatch):
    """The reference's (y, aux) and the expert ids its top_k chose."""
    seen, top_k = [], jax.lax.top_k

    def recording(a, k):
        out = top_k(a, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    y, aux = ref_moe.moe_apply(jax.tree.map(jnp.asarray, ref), jnp.asarray(x), _ref_cfg(cfg))
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return np.asarray(y), float(aux), seen[0]


def _port_run(params, x, cfg, monkeypatch):
    """The port's (y, aux) and the expert ids its route chose."""
    seen, inner = [], moe.route

    def recording(p, xx, c):
        out = inner(p, xx, c)
        seen.append(out[2])
        return out

    monkeypatch.setattr(moe, "route", recording)
    y, aux = moe.moe_apply(params, x, cfg)
    monkeypatch.setattr(moe, "route", inner)
    assert len(seen) == 1
    return y, aux, seen[0]


def _drops(ids, E, cap):
    """The dropped assignments (b, token-major index) of expert ids (B, S,
    k), GShard's rule written out as a loop."""
    out = set()
    for b in range(ids.shape[0]):
        used = [0] * E
        for j, e in enumerate(ids[b].reshape(-1)):
            if used[e] >= cap:
                out.add((b, j))
            used[e] += 1
    return out


@pytest.mark.parametrize("cf", [64.0, 1.25, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_apply_matches_reference(arch, cf, monkeypatch):
    cfg = _cfg(arch, capacity_factor=cf)
    ref, params = _params(cfg)
    x = _x(cfg)
    ry, raux, rids = _ref_run(ref, x, cfg, monkeypatch)
    y, aux, ids = _port_run(params, torch.from_numpy(x), cfg, monkeypatch)
    np.testing.assert_array_equal(ids.numpy(), rids)
    cap = moe.capacity(cfg, S)
    _, _, keep = moe.slots(ids, cfg.n_experts, cap)
    drops = {(b, j) for b, j in zip(*np.nonzero(~keep.numpy()))}
    assert drops == _drops(rids, cfg.n_experts, cap)
    assert (len(drops) == 0) == (cf == 64.0)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert float(np.abs(y.numpy() - ry).max()) <= 1e-5 * float(np.abs(ry).max())
    assert abs(float(aux) - raux) <= 1e-6 * abs(raux)


@pytest.mark.parametrize("cf", [64.0, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_gradients_match_reference(arch, cf):
    cfg = _cfg(arch, capacity_factor=cf)
    ref, params = _params(cfg, seed=2)
    x = _x(cfg, seed=3)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, xx):
        y, aux = ref_moe.moe_apply(p, xx, _ref_cfg(cfg))
        return jnp.sum(y * cot) + aux

    rgp, rgx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, ref),
                                                             jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    y, aux = moe.moe_apply(params, tx, cfg)
    names = list(params)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum() + aux,
                                [params[n] for n in names] + [tx])
    for name, g, want in zip(names + ["x"], grads, [rgp[n] for n in names] + [rgx]):
        want = np.asarray(want)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)


def test_ties_pick_the_references_experts(monkeypatch):
    """Equal gates choose the lower expert index first, as jax.lax.top_k:
    a token row of zeros gives every expert the same gate, and a router whose
    columns are zero but one gives all but one expert the same gate."""
    cfg = _cfg("olmoe-1b-7b")
    ref, params = _params(cfg)
    x = _x(cfg)
    x[0, 3] = 0.0
    x[1, :4] = 0.0
    for e in range(cfg.n_experts):
        if e != 5:
            ref["router"][:, e] = 0.0
    params = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    _, _, rids = _ref_run(ref, x, cfg, monkeypatch)
    y, _, ids = _port_run(params, torch.from_numpy(x), cfg, monkeypatch)
    np.testing.assert_array_equal(ids.numpy(), rids)
    np.testing.assert_array_equal(ids[0, 3].numpy(), [0, 1])
    # every other token: expert 5 and the lowest of the tied zeros, or the
    # two lowest of them
    assert {tuple(r) for r in ids.reshape(-1, 2).tolist()} <= {(5, 0), (0, 1)}


def test_dropped_assignments_sharing_the_last_slot(monkeypatch):
    """capacity 1 (cf 0.25, S 16, k 2, E 8): every expert's slot 0 is kept
    by its first assignment and its later ones are dropped, which the
    reference sends to the same slot cap - 1 with a zero contribution; y
    equals the reference's, and a dropped assignment adds nothing to its
    token."""
    cfg = _cfg("olmoe-1b-7b", capacity_factor=0.25)
    assert moe.capacity(cfg, S) == 1
    ref, params = _params(cfg)
    x = _x(cfg)
    ry, _, rids = _ref_run(ref, x, cfg, monkeypatch)
    y, _, ids = _port_run(params, torch.from_numpy(x), cfg, monkeypatch)
    drops = _drops(rids, cfg.n_experts, 1)
    counts = np.bincount(rids[0].reshape(-1), minlength=cfg.n_experts)
    assert counts.max() >= 3  # at least two dropped share one expert's slot 0
    assert float(np.abs(y.numpy() - ry).max()) <= 1e-5 * float(np.abs(ry).max())
    # a token with both choices dropped gets y = 0
    both = [(b, s) for b in range(B) for s in range(S)
            if (b, 2 * s) in drops and (b, 2 * s + 1) in drops]
    assert both and all(float(y[b, s].abs().max()) == 0.0 for b, s in both)


def test_forward_and_backward_are_bitwise_repeatable():
    """Two runs from the same inputs give the same y, aux and gradients,
    bit for bit (no accumulation whose order can vary)."""
    cfg = _cfg("mixtral-8x7b", capacity_factor=0.25)
    _, params = _params(cfg)
    x = torch.from_numpy(_x(cfg))

    def run():
        leaves = [p.clone().requires_grad_(True) for p in params.values()]
        tx = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply(dict(zip(params, leaves)), tx, cfg)
        return [y, aux, *torch.autograd.grad(y.square().sum() + aux, leaves + [tx])]

    assert all(torch.equal(a, b) for a, b in zip(run(), run()))


def test_moe_init_draws_in_the_references_order():
    """router (d, E), w_gate and w_up (E, d, f), w_down (E, f, d), drawn in
    that order; fan-in is the first axis (E for the stacked experts), as
    the reference's dense_init takes it."""
    cfg = _cfg("olmoe-1b-7b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    shapes = jax.tree.map(lambda a: a.shape, ref_moe.moe_init(jax.random.PRNGKey(0),
                                                              _ref_cfg(cfg), jnp.float32))
    assert list(p) == list(moe.DRAWN) and {k: tuple(v.shape) for k, v in p.items()} == shapes
    g = torch.Generator().manual_seed(0)
    from repro_torch.models.common import dense_init
    for name in moe.DRAWN:
        assert torch.equal(p[name], dense_init(g, tuple(p[name].shape), torch.float32))
    assert float(p["w_gate"].abs().max()) <= 2 / np.sqrt(cfg.n_experts)
