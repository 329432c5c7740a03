"""The port's xLSTM mixers (``repro_torch.models.xlstm``) and its xLSTM stack
(``block_pattern == "xlstm"``) against the reference, on the CPU; and the
tree helpers that the stack's list of blocks reaches.

Inputs are made from a numpy seed and handed to both packages in float32;
the reference's parameters are carried across as numpy arrays (its
``b_gates`` and ``b`` redrawn from the seed, so that the gates vary).
Tolerances:

* one mixer's outputs, final states and conv tails: 1e-5 of max
  |reference| (``MIX_REL``: the same f32 arithmetic; the chunked products
  contract in another order);
* the stack's logits, states, losses and gradients, and AdamW's steps:
  1e-4 of max |reference| (``REL``, the model tolerance of
  ``tests/test_torch_lm.py``);
* the chunk-256 mLSTM gradient at L = 512 against the reference's at the
  same chunk, which is finite there: ``REL`` of the largest |gradient|;
* the tree helpers on a dict tree against their dict-only forms, and a
  train step repeated: bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xl
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch.configs import base
from repro_torch.convert import lm_params, train_state
from repro_torch.data import pipeline
from repro_torch.distributed import compression
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer, xlstm
from repro_torch.optim import adamw
from repro_torch.train import trainer

MIX_REL = 1e-5
REL = 1e-4


def _cfg(**kw):
    return dataclasses.replace(base.get_reduced("xlstm-125m"), dtype="float32", **kw)


def _ref_cfg(cfg):
    return ref_base.ArchConfig(**dataclasses.asdict(cfg))


def _close(port, ref, rel):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _mixer(kind, cfg, seed=0):
    """One mixer's parameters as numpy arrays: the reference's init, with
    its f32 gate biases drawn from the seed."""
    init = ref_xl.mlstm_init if kind == "mlstm" else ref_xl.slstm_init
    p = {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(seed), _ref_cfg(cfg),
                                           jnp.float32).items()}
    name = "b_gates" if kind == "mlstm" else "b"
    p[name] = np.random.default_rng(seed).standard_normal(p[name].shape).astype(np.float32)
    return p


def _port(p, requires_grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(requires_grad) for k, v in p.items()}


def _ref(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(cfg, L, seed=1, B=2):
    return np.random.default_rng(seed).standard_normal((B, L, cfg.d_model)).astype(np.float32)


def _key(key):
    """A jax path entry's dict key or sequence index."""
    return key.key if hasattr(key, "key") else key.idx


def _leaf(tree, path):
    for key in path:
        tree = tree[_key(key)]
    return tree


def _state_close(state, rstate, rel):
    """A state (an mLSTM's dict, an sLSTM's tuple, the stack's list) leaf by
    leaf, with the reference's paths and leaf count."""
    leaves = jax.tree_util.tree_leaves_with_path(rstate)
    assert len(leaves) == len(list(transformer._leaves(state)))
    for path, a in leaves:
        _close(_leaf(state, path), a, rel)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------
def test_init_and_shapes_are_the_references():
    """Both mixers' shapes and constants equal the reference's; b_gates and
    b are float32 in a bfloat16 model, the others bf16; conv_w is drawn at
    scale 0.5 and r at 0.3 (|w| <= 2 x scale)."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    for kind, ref_init, init, shapes in (
            ("mlstm", ref_xl.mlstm_init, xlstm.mlstm_init, xlstm.mlstm_shapes(cfg)),
            ("slstm", ref_xl.slstm_init, xlstm.slstm_init, xlstm.slstm_shapes(cfg))):
        ref = ref_init(jax.random.PRNGKey(0), _ref_cfg(cfg), jnp.bfloat16)
        port = init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
        assert list(port) == list(shapes) and set(port) == set(ref), kind
        for name, a in ref.items():
            assert tuple(port[name].shape) == a.shape == shapes[name], name
            assert (port[name].dtype == torch.float32) == (a.dtype == jnp.float32), name
            assert (name in xlstm.F32_PARAMS) == (a.dtype == jnp.float32), name
            if name in xlstm.CONSTANTS:
                np.testing.assert_array_equal(port[name].float().numpy(),
                                              np.asarray(a, np.float32))
        assert [n for n, _ in xlstm.DRAWN[kind]] == [n for n in shapes if n not in xlstm.CONSTANTS]
    assert float(port["r"].float().abs().max()) <= 0.6 * (1 + 2**-7)  # bf16's rounding
    assert xlstm.mlstm_shapes(base.get_config("xlstm-125m"))["wq"] == (1536, 1536)


@pytest.mark.parametrize("L,chunk", [(48, 1), (48, 4), (48, 16), (40, 16)])
def test_mlstm_apply_matches_reference(L, chunk):
    """Output and final state (C, n, m, conv tail): 48 chunks of 1, 12 of 4,
    3 of 16, and L = 40 at chunk 16 (chunk_len gives 4 chunks of 10)."""
    cfg = _cfg(chunk_size=chunk)
    p, x = _mixer("mlstm", cfg), _x(cfg, L)
    y, st = xlstm.mlstm_apply(_port(p), torch.from_numpy(x), cfg)
    ry, rst = ref_xl.mlstm_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    _close(y, ry, MIX_REL)
    _state_close(st, rst, MIX_REL)


@pytest.mark.parametrize("L", [1, 2])
def test_mlstm_conv_tail_below_the_window(L):
    """L < W - 1 = 3: the conv tail is the L inputs, zero-padded in front
    to W - 1 rows, as the reference pads it."""
    cfg = _cfg()
    p, x = _mixer("mlstm", cfg), _x(cfg, L)
    y, st = xlstm.mlstm_apply(_port(p), torch.from_numpy(x), cfg)
    ry, rst = ref_xl.mlstm_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    assert tuple(st["conv"].shape) == (2, cfg.conv_width - 1, 2 * cfg.d_model)
    assert not st["conv"][:, :cfg.conv_width - 1 - L].any()
    _close(y, ry, MIX_REL)
    _state_close(st, rst, MIX_REL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_after_prefill_matches_apply(kind):
    """The chunked (mLSTM) or scanned (sLSTM) apply over 24 tokens, then the
    decode step over the next 9, one at a time, gives the apply's outputs of
    the 33 tokens at those positions (the port's and the reference's), and
    ends in its final state."""
    cfg = _cfg(chunk_size=8)
    p, x = _mixer(kind, cfg), _x(cfg, 33)
    apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
    decode = xlstm.mlstm_decode if kind == "mlstm" else xlstm.slstm_decode
    ref_apply = ref_xl.mlstm_apply if kind == "mlstm" else ref_xl.slstm_apply
    pt = _port(p)
    y, st = apply(pt, torch.from_numpy(x), cfg)
    ry, rst = ref_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    _close(y, ry, MIX_REL)
    _, state = apply(pt, torch.from_numpy(x[:, :24]), cfg)
    steps = []
    for t in range(24, 33):
        out, state = decode(pt, torch.from_numpy(x[:, t:t + 1]), cfg, state)
        steps.append(out)
    got = torch.cat(steps, dim=1)
    _close(got, y[:, 24:], MIX_REL)
    _close(got, np.asarray(ry)[:, 24:], MIX_REL)
    _state_close(state, rst, MIX_REL)
    assert isinstance(state, dict if kind == "mlstm" else tuple)


def test_slstm_apply_from_zero_state_matches_reference():
    """The sLSTM over 20 positions and its decode from the zero state
    (``init_slstm_state``) over the same 20: outputs and carries."""
    cfg = _cfg()
    p, x = _mixer("slstm", cfg, seed=3), _x(cfg, 20, seed=4)
    pt = _port(p)
    y, carry = xlstm.slstm_apply(pt, torch.from_numpy(x), cfg)
    ry, rcarry = ref_xl.slstm_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    _close(y, ry, MIX_REL)
    _state_close(carry, rcarry, MIX_REL)
    state = xlstm.init_slstm_state(cfg, 2)
    _state_close(state, ref_xl.init_slstm_state(_ref_cfg(cfg), 2, jnp.float32), MIX_REL)
    outs = []
    for t in range(20):
        out, state = xlstm.slstm_decode(pt, torch.from_numpy(x[:, t:t + 1]), cfg, state)
        outs.append(out)
    _close(torch.cat(outs, dim=1), ry, MIX_REL)
    _state_close(state, rcarry, MIX_REL)


def test_mlstm_chunk_256_gradient_matches_reference():
    """L = 512 in two chunks of 256 (xlstm-125m's chunk) at the reduced
    width, B = 1: the port's gradient of sum(y^2) is finite and equals the
    reference's at the same chunk, which is finite there (unlike the
    Mamba2 reference's at chunk 256)."""
    cfg = _cfg(chunk_size=256)
    p, x = _mixer("mlstm", cfg), _x(cfg, 512, B=1)
    pt = _port(p, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = xlstm.mlstm_apply(pt, xt, cfg)
    names = list(p)
    grads = torch.autograd.grad(y.square().sum(), [pt[n] for n in names] + [xt])
    rcfg = _ref_cfg(cfg)
    gp, gx = jax.jit(jax.grad(lambda pp, xx: jnp.sum(ref_xl.mlstm_apply(pp, xx, rcfg)[0] ** 2),
                              argnums=(0, 1)))(_ref(p), jnp.asarray(x))
    for name, g, w in zip(names + ["x"], grads, [gp[n] for n in names] + [gx]):
        assert bool(torch.isfinite(g).all()) and np.isfinite(np.asarray(w)).all(), name
        _close(g, w, REL)


# ---------------------------------------------------------------------------
# the xLSTM stack (block_pattern "xlstm")
# ---------------------------------------------------------------------------
def _stack(**kw):
    cfg = _cfg(**kw)
    rcfg = _ref_cfg(cfg)
    ref = ref_tf.init_params(jax.random.PRNGKey(0), rcfg)
    return cfg, rcfg, ref, lm_params(jax.tree.map(np.asarray, ref), cfg, device="cpu")


def test_stack_layout_is_the_references():
    """A list of per-layer blocks: an sLSTM block's leaves at its top, an
    mLSTM block's under "mixer" beside its pre-norm; param_shapes and
    init_params give the reference's tree; no attention."""
    cfg, rcfg, ref, port = _stack()
    shapes = transformer.param_shapes(cfg)
    assert isinstance(port["blocks"], list) and isinstance(shapes["blocks"], list)
    assert transformer._tree_map(lambda a: tuple(a.shape), port) == shapes == jax.tree.map(
        lambda a: a.shape, ref)
    assert set(shapes["blocks"][1]) == {"w_in", "r", "b", "norm", "w_out"}
    assert set(shapes["blocks"][0]) == {"norm", "mixer"}
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    assert transformer._tree_map(lambda a: tuple(a.shape), params) == shapes
    assert transformer.param_count(params) == ref_tf.param_count(ref)
    assert transformer.attention_layers(cfg) == 0
    full = base.get_config("xlstm-125m")
    assert sum(np.prod(s) for s in transformer._leaves(transformer.param_shapes(full))) == (
        190_744_400)


def test_stack_forward_prefill_decode_match_reference():
    """The stack's hidden states, prefill logits and per-layer states (the
    mLSTM's C, n, m, conv; the sLSTM's (c, n, h, m)) at chunk 8, then three
    decode steps, every leaf; no flash call."""
    cfg, rcfg, ref, port = _stack(chunk_size=8)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 23)).astype(np.int32)
    S = 20
    flash_ops.reset_counts()
    with torch.no_grad():
        hidden, aux = transformer.forward(port, {"tokens": torch.from_numpy(toks).long()}, cfg)
    rhidden, _ = jax.jit(ref_tf.forward, static_argnums=(2,))(
        ref, {"tokens": jnp.asarray(toks)}, rcfg)
    _close(hidden, rhidden, REL)
    assert aux == 0.0
    logits, state = transformer.prefill(port, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                        cfg, max_len=32)
    rlogits, rstate = jax.jit(ref_tf.prefill, static_argnums=(2, 3))(
        ref, {"tokens": jnp.asarray(toks[:, :S])}, rcfg, 32)
    ref_decode = jax.jit(ref_tf.decode_step, static_argnums=(4,))
    _close(logits, rlogits, REL)
    _state_close(state, rstate, REL)
    for pos in range(S, S + 3):
        logits, state = transformer.decode_step(
            port, torch.from_numpy(toks[:, pos:pos + 1]).long(), state, pos, cfg)
        rlogits, rstate = ref_decode(ref, jnp.asarray(toks[:, pos:pos + 1]), rstate,
                                     jnp.int32(pos), rcfg)
        _close(logits, rlogits, REL)
        _state_close(state, rstate, REL)
    assert len(list(transformer._leaves(state))) == 8
    c = flash_ops.counts["flash_attention"]
    assert (c.launches, c.plain_calls) == (0, 0)


@pytest.mark.parametrize("remat", [True, False])
def test_stack_loss_and_grads_match_reference(remat):
    """Loss and every gradient at chunk 4 over S = 32 (8 chunks a layer);
    the reference takes no remat for xLSTM, the port rematerializes each
    mLSTM block under ``remat``: the same values."""
    cfg, rcfg, ref, port = _stack(chunk_size=4)
    for a in transformer._leaves(port):
        a.requires_grad_(True)
    batch = pipeline.make_batch(cfg, base.ShapeConfig("t", "train", 32, 2), 1)
    rloss, rgrads = jax.jit(jax.value_and_grad(ref_tf.loss_fn), static_argnums=(2,),
                            static_argnames=("remat",))(
        ref, jax.tree.map(jnp.asarray, batch), rcfg, remat=remat)
    loss = transformer.loss_fn(port, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                               remat=remat)
    leaves = jax.tree_util.tree_leaves_with_path(rgrads)
    grads = torch.autograd.grad(loss, [_leaf(port, path) for path, _ in leaves])
    _close(loss, rloss, REL)
    for (path, w), g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), path
        _close(g, w, REL)


def test_stack_three_train_steps_match_reference():
    """Three AdamW steps from the reference's state at chunk 4: each step's
    loss, grad norm and lr to REL, the final moments to REL, the final
    parameters to REL of a leaf's max on every element whose clipped
    gradient is 0 or above 100 eps (``test_three_train_steps_match_
    reference``'s rule)."""
    cfg = _cfg(chunk_size=4)
    rcfg = _ref_cfg(cfg)
    opt = adamw.AdamWConfig(total_steps=3, warmup_steps=1)
    rstate = ref_trainer.train_state_init(jax.random.PRNGKey(0), rcfg)
    state = train_state(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    rstep = jax.jit(ref_trainer.make_train_step(rcfg, ref_adamw.AdamWConfig(
        **dataclasses.asdict(opt))))
    step = trainer.make_train_step(cfg, opt)
    shape = base.ShapeConfig("t", "train", 16, 2)
    paths = [path for path, _ in jax.tree_util.tree_leaves_with_path(rstate.params)]
    noise = {jax.tree_util.keystr(p): False for p in paths}
    for i in range(3):
        batch = pipeline.make_batch(cfg, shape, i)
        m_before = jax.tree.map(np.asarray, rstate.opt_state["m"])
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], rm[k], REL)
        for path in paths:
            g = (np.asarray(_leaf(rstate.opt_state["m"], path))
                 - opt.beta1 * _leaf(m_before, path)) / (1 - opt.beta1)
            key = jax.tree_util.keystr(path)
            noise[key] = noise[key] | ((np.abs(g) <= 100 * opt.eps) & (g != 0))
    assert int(state.step) == int(rstate.step) == 3
    for path in paths:
        for name in ("m", "v"):
            _close(_leaf(state.opt_state[name], path), _leaf(rstate.opt_state[name], path), REL)
        want = np.asarray(_leaf(rstate.params, path))
        keep = ~noise[jax.tree_util.keystr(path)]
        err = float(np.abs(_leaf(state.params, path).detach().numpy() - want)[keep].max(
            initial=0.0))
        assert err <= REL * float(np.abs(want).max()), (path, err)


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------
def test_bf16_model_keeps_f32_leaves():
    """init_params and lm_params of a bf16 xLSTM: b_gates and b float32 (as
    the reference keeps them), every other leaf bf16; lm_params with an
    explicit dtype (the moments) casts them all."""
    cfg = base.get_reduced("xlstm-125m")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    for got in (params, lm_params(ref, cfg, device="cpu")):
        for path, a in jax.tree_util.tree_leaves_with_path(ref):
            t = _leaf(got, path)
            want = torch.float32 if _key(path[-1]) in xlstm.F32_PARAMS else torch.bfloat16
            assert t.dtype == want and (a.dtype == np.float32) == (want == torch.float32), path
    moments = lm_params(ref, cfg, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in transformer._leaves(moments))


def test_train_step_is_bitwise_repeatable_on_one_thread():
    """One reduced bf16 train step (the mLSTM blocks rematerialized, the chunk
    loop, the sLSTM's position loop) twice from one state on one CPU
    thread: loss, gradients, parameters and moments bitwise."""
    cfg = base.get_reduced("xlstm-125m")
    host = jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    batch = {k: torch.from_numpy(v) for k, v in
             pipeline.make_batch(cfg, base.ShapeConfig("t", "train", 32, 2), 0).items()}
    step = trainer.make_train_step(cfg, adamw.AdamWConfig(total_steps=3, warmup_steps=1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for _ in range(2):
            state = trainer.train_state_init(None, cfg, params=lm_params(host, cfg, device="cpu"))
            grads = torch.autograd.grad(transformer.loss_fn(state.params, batch, cfg),
                                        list(transformer._leaves(state.params)))
            state, m = step(state, batch)
            runs.append([m["loss"], *grads, *transformer._leaves(state.params),
                         *transformer._leaves(state.opt_state)])
    finally:
        torch.set_num_threads(threads)
    assert bool(torch.isfinite(runs[0][0]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# The tree helpers as they were before they walked lists: dicts only.
def _adamw_tree_map_dicts(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _adamw_tree_map_dicts(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves_dicts(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_dicts(v)
    else:
        yield tree


def _rebuild_dicts(like, leaves):
    if isinstance(like, dict):
        return {k: _rebuild_dicts(v, leaves) for k, v in like.items()}
    return next(leaves)


def _map_pairs_dicts(fn, a, b):
    if isinstance(a, dict):
        pairs = {k: _map_pairs_dicts(fn, a[k], b[k]) for k in a}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    return fn(a, b)


def _zeros_like_f32_dicts(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_f32_dicts(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def _same(a, b):
    """Two trees of one structure (dicts in one key order), every leaf
    bitwise equal."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _adamw_with(monkeypatch, walkers, params, grads, clip_norm=1.0):
    """adamw_init and one adamw_update of ``params`` with ``grads``, with
    AdamW's tree walkers ``walkers`` (its ``_tree_map``, ``_leaves``)."""
    monkeypatch.setattr(adamw, "_tree_map", walkers[0])
    monkeypatch.setattr(adamw, "_leaves", walkers[1])
    try:
        params = transformer._tree_map(lambda t: t.detach().clone(), params)
        opt = adamw.adamw_init(params)
        cfg = adamw.AdamWConfig(total_steps=3, warmup_steps=1, clip_norm=clip_norm)
        return adamw.adamw_update(cfg, params, grads, opt)
    finally:
        monkeypatch.undo()


def _pair(g, r):
    """A per-leaf function of two tensors giving a pair, for _map_pairs."""
    return g + r, g - 2 * r


def test_tree_helpers_on_dicts_as_before_and_on_lists_in_index_order(monkeypatch):
    """AdamW's walkers, the trainer's ``_rebuild``, compression's
    ``_map_pairs``/``_zeros_like_f32`` and ``lm_params`` on a dict tree
    (reduced qwen3-1.7b) give bitwise what their dict-only forms gave.  On
    the xLSTM's list of blocks they walk the blocks in index order: the
    leaves come block after block, and each block's result is bitwise that
    of the block alone as a dict tree (AdamW with a clip norm that does not
    clip, so that the blocks do not share a clip scale)."""
    gen = torch.Generator().manual_seed(0)
    trees = {}
    for arch in ("qwen3-1.7b", "xlstm-125m"):
        cfg = dataclasses.replace(base.get_reduced(arch), dtype="float32")
        params = transformer.init_params(gen, cfg)
        grads = transformer._tree_map(
            lambda t: torch.randn(t.shape, generator=gen, dtype=t.dtype), params)
        trees[arch] = (cfg, params, grads)
    new_walkers = (adamw._tree_map, adamw._leaves)

    # a dict tree: the helpers against their dict-only forms
    cfg, params, grads = trees["qwen3-1.7b"]
    new = _adamw_with(monkeypatch, new_walkers, params, grads)
    old = _adamw_with(monkeypatch, (_adamw_tree_map_dicts, _leaves_dicts), params, grads)
    assert all(_same(a, b) for a, b in zip(new, old))
    leaves = list(_leaves_dicts(grads))
    assert _same(trainer._rebuild(params, iter(leaves)), _rebuild_dicts(params, iter(leaves)))
    res = compression._zeros_like_f32(grads)
    assert _same(res, _zeros_like_f32_dicts(grads))
    res = transformer._tree_map(lambda t: torch.randn(t.shape, generator=gen), grads)
    assert _same(compression._map_pairs(_pair, grads, res),
                 _map_pairs_dicts(_pair, grads, res))
    host = jax.tree.map(lambda t: t.numpy(), params)
    assert _same(lm_params(host, cfg, device="cpu"), params)

    # the list of blocks: index order, each block as its own dict tree
    cfg, params, grads = trees["xlstm-125m"]
    blocks, gblocks = params["blocks"], grads["blocks"]
    in_order = [t for b in blocks for t in _leaves_dicts(b)]
    for walk in (adamw._leaves, transformer._leaves):
        assert [id(t) for t in walk(blocks)] == [id(t) for t in in_order]
    whole = _adamw_with(monkeypatch, new_walkers, {"blocks": blocks}, {"blocks": gblocks},
                        clip_norm=1e30)
    assert isinstance(whole[0]["blocks"], list) and isinstance(whole[1]["v"]["blocks"], list)
    for i, (b, g) in enumerate(zip(blocks, gblocks)):
        alone = _adamw_with(monkeypatch, new_walkers, b, g, clip_norm=1e30)
        assert _same(whole[0]["blocks"][i], alone[0])
        assert all(_same(whole[1][k]["blocks"][i], alone[1][k]) for k in ("m", "v"))
    rebuilt = trainer._rebuild(params, iter(list(transformer._leaves(grads))))
    assert isinstance(rebuilt["blocks"], list) and _same(rebuilt, grads)
    res = compression._zeros_like_f32(grads)
    assert isinstance(res["blocks"], list) and _same(res["blocks"][0],
                                                     _zeros_like_f32_dicts(gblocks[0]))
    res = transformer._tree_map(lambda t: torch.randn(t.shape, generator=gen), grads)
    out, other = compression._map_pairs(_pair, grads, res)
    for i, g in enumerate(gblocks):
        alone = _map_pairs_dicts(_pair, g, res["blocks"][i])
        assert _same(out["blocks"][i], alone[0]) and _same(other["blocks"][i], alone[1])
    host = jax.tree.map(lambda t: t.numpy(), params)
    got = lm_params(host, cfg, device="cpu")
    assert isinstance(got["blocks"], list) and _same(got, params)
    with pytest.raises(ValueError, match="blocks has 1 blocks, expected 2"):
        lm_params(dict(host, blocks=host["blocks"][:1]), cfg, device="cpu")


def test_slstm_gradient_at_full_width_overflows_as_the_references():
    """xlstm-125m's sLSTM at full width (d_model 768, 4 heads of 192, r
    drawn at std 0.3 whatever the head dim), B = 1, inputs at the
    embeddings' scale: the gradient of mean(y^2) equals the reference's at
    L = 32 (REL); by L = 2048 it has overflowed f32 in both packages (its
    norm grows ~9% a position: about 2.2 at L = 64, 3.5e7 at 256), the
    caveat of the reference that ROADMAP.md (Queue 3) records: xlstm-125m's
    gradient at train_4k's S = 4096 is not finite in either package."""
    cfg = dataclasses.replace(base.get_config("xlstm-125m"), dtype="float32")
    rcfg = _ref_cfg(cfg)
    p = _mixer("slstm", cfg)
    p["b"][:] = 0.0  # the reference's init
    grad = jax.jit(jax.grad(lambda pp, xx: jnp.mean(ref_xl.slstm_apply(pp, xx, rcfg)[0] ** 2),
                            argnums=(0, 1)))
    for L in (32, 2048):
        x = 0.0045 * _x(cfg, L, B=1)
        pt = _port(p, requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = xlstm.slstm_apply(pt, xt, cfg)
        names = list(p)
        grads = torch.autograd.grad(y.square().mean(), [pt[n] for n in names] + [xt])
        gp, gx = grad(_ref(p), jnp.asarray(x))
        want = [gp[n] for n in names] + [gx]
        finite = [bool(torch.isfinite(g).all()) for g in grads]
        ref_finite = [bool(np.isfinite(np.asarray(w)).all()) for w in want]
        if L == 32:
            assert all(finite) and all(ref_finite)
            for name, g, w in zip(names + ["x"], grads, want):
                _close(g, w, REL)
        else:
            assert not all(finite) and not all(ref_finite)


def test_profile_span_lookup_is_the_linear_scan():
    """``profiling._span_lookup`` (bisection, for phase 13's profile of a
    million events) gives, at every time, the first category whose span
    holds it, as the linear scan over the spans does: random spans of three
    categories, overlapping within and across categories."""
    from repro_torch.profiling import _span_lookup

    rng = np.random.default_rng(0)
    for _ in range(100):
        spans = [(cat, int(lo), int(lo + n)) for cat in "abc"
                 for lo, n in zip(rng.integers(0, 100, rng.integers(0, 7)),
                                  rng.integers(0, 30, 7))]
        find = _span_lookup(spans)
        for t in range(-5, 140):
            assert find(t) == next((c for c, lo, hi in spans if lo <= t < hi), None)
