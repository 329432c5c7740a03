"""The port's Mamba2 mixer (``repro_torch.models.ssm``) and its Mamba2 stack
(``block_pattern == "mamba2"``) against the reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages in float32;
the reference's parameters are carried across as numpy arrays (its
``a_log`` and ``dt_bias`` redrawn from the seed, so that A and dt vary by
head).  Tolerances:

* mixer outputs, final ssm states and conv tails: 1e-5 of max
  |reference| (the same f32 arithmetic; the chunked products contract in
  another order);
* the chunked scan's gradients at L = 256 in one chunk of 256 against the
  reference's at chunk 16, which are finite there: 1e-4 of the largest
  |gradient| (chunking is exact: the two are one function);
* the Mamba2 stack's logits, states, loss and gradients: 1e-4 of max
  |reference|, the model tolerance of ``tests/test_torch_lm.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch.configs import base
from repro_torch.convert import lm_params, train_state
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import ssm, transformer
from repro_torch.optim import adamw
from repro_torch.train import trainer

MIX_REL = 1e-5
REL = 1e-4


def _cfg(**kw):
    return dataclasses.replace(base.get_reduced("zamba2-2.7b"), dtype="float32", **kw)


def _ref_cfg(cfg):
    return ref_base.ArchConfig(**dataclasses.asdict(cfg))


def _close(port, ref, rel):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _mixer(cfg, seed=0):
    """One layer's parameters as numpy arrays: the reference's init, with
    a_log and dt_bias drawn from the seed."""
    p = {k: np.asarray(v) for k, v in
         ref_ssm.mamba2_init(jax.random.PRNGKey(seed), _ref_cfg(cfg), jnp.float32).items()}
    rng = np.random.default_rng(seed)
    p["a_log"] = (0.5 * rng.standard_normal(p["a_log"].shape)).astype(np.float32)
    p["dt_bias"] = (0.5 * rng.standard_normal(p["dt_bias"].shape)).astype(np.float32)
    return p


def _port(p, requires_grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(requires_grad) for k, v in p.items()}


def _ref(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(cfg, L, seed=1, B=2):
    return np.random.default_rng(seed).standard_normal((B, L, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L", [1, 2, 7, 12, 33, 100, 257])
def test_chunk_len_is_the_references(L):
    for chunk in (1, 4, 16, 256):
        q = ssm.chunk_len(L, chunk)
        assert q == ref_ssm.chunk_len(L, chunk) and L % q == 0 and q <= chunk


def test_init_and_shapes_are_the_references():
    """One layer's shapes and constants equal the reference's; a_log,
    d_skip and dt_bias are float32 in a bfloat16 model, the others bf16;
    conv_w is drawn at scale 0.5 (|w| <= 2 x 0.5)."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    ref = ref_ssm.mamba2_init(jax.random.PRNGKey(0), _ref_cfg(cfg), jnp.bfloat16)
    port = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert set(port) == set(ref) == set(ssm.mamba2_shapes(cfg))
    for name, a in ref.items():
        assert tuple(port[name].shape) == a.shape == ssm.mamba2_shapes(cfg)[name]
        assert (port[name].dtype == torch.float32) == (a.dtype == jnp.float32)
        if name in ssm.CONSTANTS:
            np.testing.assert_array_equal(port[name].float().numpy(), np.asarray(a, np.float32))
    assert float(port["conv_w"].float().abs().max()) <= 1.0


@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
def test_mamba2_apply_matches_reference(chunk):
    """Output, final ssm state and conv tail at L = 48: 48 chunks of 1,
    12 of 4, 6 of 8, 3 of 16."""
    cfg = _cfg(chunk_size=chunk)
    p, x = _mixer(cfg), _x(cfg, 48)
    y, st = ssm.mamba2_apply(_port(p), torch.from_numpy(x), cfg)
    ry, rst = ref_ssm.mamba2_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    _close(y, ry, MIX_REL)
    for name in ("ssm", "conv"):
        assert tuple(st[name].shape) == rst[name].shape
        _close(st[name], rst[name], MIX_REL)


@pytest.mark.parametrize("L", [1, 2])
def test_conv_state_below_the_window(L):
    """L < W - 1 = 3: the conv tail is the L inputs, zero-padded in front
    to W - 1 rows, as the reference pads it."""
    cfg = _cfg()
    p, x = _mixer(cfg), _x(cfg, L)
    y, st = ssm.mamba2_apply(_port(p), torch.from_numpy(x), cfg)
    ry, rst = ref_ssm.mamba2_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    assert tuple(st["conv"].shape) == rst["conv"].shape == (2, cfg.conv_width - 1, 160)
    assert not st["conv"][:, :cfg.conv_width - 1 - L].any()
    _close(st["conv"], rst["conv"], MIX_REL)
    _close(y, ry, MIX_REL)


def test_decode_stepped_matches_chunked_apply():
    """mamba2_decode from a zero state over L = 40 tokens, one at a time,
    gives the chunked apply's outputs (the port's and the reference's), and
    ends in its final state."""
    cfg = _cfg()
    p, x = _mixer(cfg), _x(cfg, 40)
    pt = _port(p)
    y, st = ssm.mamba2_apply(pt, torch.from_numpy(x), cfg)
    ry, _ = ref_ssm.mamba2_apply(_ref(p), jnp.asarray(x), _ref_cfg(cfg))
    state = ssm.init_mamba2_state(cfg, 2, torch.float32)
    steps = []
    for t in range(x.shape[1]):
        out, state = ssm.mamba2_decode(pt, torch.from_numpy(x[:, t:t + 1]), cfg, state)
        steps.append(out)
    got = torch.cat(steps, dim=1)
    _close(got, y, MIX_REL)
    _close(got, ry, MIX_REL)
    _close(state["ssm"], st["ssm"], MIX_REL)
    _close(state["conv"], st["conv"], MIX_REL)


def test_chunk_256_gradient_is_finite_and_the_references_at_chunk_16():
    """L = 256 in one chunk of 256 (zamba2-2.7b's chunk): the port's
    gradient of sum(y^2) is finite and equals the reference's at chunk 16;
    the reference's own at chunk 256 is not finite (it exponentiates the
    masked upper triangle, past f32's exp limit), the caveat ROADMAP.md
    records."""
    L = 256
    cfg = _cfg(chunk_size=256)
    p, x = _mixer(cfg), _x(cfg, L, B=1)
    pt = _port(p, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = ssm.mamba2_apply(pt, xt, cfg)
    names = sorted(p)
    grads = torch.autograd.grad(y.square().sum(), [pt[n] for n in names] + [xt])
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    def ref_grads(chunk):
        rcfg = _ref_cfg(dataclasses.replace(cfg, chunk_size=chunk))
        return jax.jit(jax.grad(
            lambda pp, xx: jnp.sum(ref_ssm.mamba2_apply(pp, xx, rcfg)[0] ** 2),
            argnums=(0, 1)))(_ref(p), jnp.asarray(x))

    gp, gx = ref_grads(16)
    want = [gp[n] for n in names] + [gx]
    for name, g, w in zip(names + ["x"], grads, want):
        assert np.isfinite(np.asarray(w)).all(), name
        _close(g, w, REL)
    gp256, gx256 = ref_grads(256)
    assert not all(np.isfinite(np.asarray(a)).all() for a in [*gp256.values(), gx256])


# ---------------------------------------------------------------------------
# the Mamba2 stack (block_pattern "mamba2")
# ---------------------------------------------------------------------------
def _stack():
    cfg = _cfg(block_pattern="mamba2")
    rcfg = _ref_cfg(cfg)
    ref = ref_tf.init_params(jax.random.PRNGKey(0), rcfg)
    return cfg, rcfg, ref, lm_params(jax.tree.map(np.asarray, ref), cfg, device="cpu")


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_mamba2_stack_forward_prefill_decode_match_reference():
    """The stack's hidden states, prefill logits and stacked states (ssm
    (L, B, H, N, P), conv (L, B, W - 1, C)), then three decode steps; no
    attention, so no flash call."""
    cfg, rcfg, ref, port = _stack()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 23)).astype(np.int32)
    S = 20
    flash_ops.reset_counts()
    with torch.no_grad():
        hidden, aux = transformer.forward(port, {"tokens": torch.from_numpy(toks).long()}, cfg)
    rhidden, _ = ref_tf.forward(ref, {"tokens": jnp.asarray(toks)}, rcfg)
    _close(hidden, rhidden, REL)
    assert aux == 0.0
    logits, state = transformer.prefill(port, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                        cfg, max_len=32)
    rlogits, rstate = ref_tf.prefill(ref, {"tokens": jnp.asarray(toks[:, :S])}, rcfg,
                                     max_len=32)
    _close(logits, rlogits, REL)
    for t in range(4):
        if t:
            pos = S + t - 1
            logits, state = transformer.decode_step(
                port, torch.from_numpy(toks[:, pos:pos + 1]).long(), state, pos, cfg)
            rlogits, rstate = ref_tf.decode_step(ref, jnp.asarray(toks[:, pos:pos + 1]),
                                                 rstate, jnp.int32(pos), rcfg)
            _close(logits, rlogits, REL)
        leaves = jax.tree_util.tree_leaves_with_path(rstate)
        assert len(leaves) == 2 == len(list(transformer._leaves(state)))
        for path, a in leaves:
            assert tuple(_leaf(state, path).shape) == a.shape
            _close(_leaf(state, path), a, REL)
    assert flash_ops.counts["flash_attention"].plain_calls == 0


@pytest.mark.parametrize("remat", [True, False])
def test_mamba2_stack_loss_and_grads_match_reference(remat):
    cfg, rcfg, ref, port = _stack()
    for a in transformer._leaves(port):
        a.requires_grad_(True)
    batch = pipeline.make_batch(cfg, base.ShapeConfig("t", "train", 64, 2), 1)
    rloss, rgrads = jax.value_and_grad(ref_tf.loss_fn)(
        ref, jax.tree.map(jnp.asarray, batch), rcfg, remat=remat)
    loss = transformer.loss_fn(port, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                               remat=remat)
    leaves = jax.tree_util.tree_leaves_with_path(rgrads)
    grads = torch.autograd.grad(loss, [_leaf(port, path) for path, _ in leaves])
    _close(loss, rloss, REL)
    for (path, w), g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), path
        _close(g, w, REL)


def test_mamba2_stack_three_train_steps_match_reference():
    """Three AdamW steps from the reference's state: each step's loss, grad
    norm and lr to REL, the final moments to REL, the final parameters to
    REL of a leaf's max on every element whose clipped gradient is 0 or
    above 100 eps (``test_three_train_steps_match_reference``'s rule)."""
    cfg = _cfg(block_pattern="mamba2")
    rcfg = _ref_cfg(cfg)
    opt = adamw.AdamWConfig(total_steps=3, warmup_steps=1)
    rstate = ref_trainer.train_state_init(jax.random.PRNGKey(0), rcfg)
    state = train_state(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    rstep = jax.jit(ref_trainer.make_train_step(rcfg, ref_adamw.AdamWConfig(
        **dataclasses.asdict(opt))))
    step = trainer.make_train_step(cfg, opt)
    shape = base.ShapeConfig("t", "train", 32, 2)
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
    """init_params and lm_params of a bf16 zamba2: the mixers' a_log, d_skip
    and dt_bias float32 (as the reference keeps them), every other leaf
    bf16; lm_params with an explicit dtype (the moments) casts them all."""
    cfg = base.get_reduced("zamba2-2.7b")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    for got in (params, lm_params(ref, cfg, device="cpu")):
        mixer = got["blocks"]["mixer"]
        for name, t in mixer.items():
            assert t.dtype == (torch.float32 if name in ssm.F32_PARAMS else torch.bfloat16), name
        assert got["shared"]["attn"]["wq"].dtype == torch.bfloat16
        assert got["shared"]["attn"]["wq"].shape == (cfg.d_model, cfg.d_model)
    moments = lm_params(ref, cfg, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in transformer._leaves(moments))
    for name in ssm.F32_PARAMS:
        np.testing.assert_array_equal(params["blocks"]["mixer"][name].numpy(),
                                      np.asarray(ref["blocks"]["mixer"][name]))


def test_zamba2_train_step_is_bitwise_repeatable():
    """One reduced zamba2 train step (nested remat, the chunk loop) twice
    from one state: loss, gradients, parameters and moments bitwise."""
    cfg = _cfg()
    host = jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    batch = {k: torch.from_numpy(v) for k, v in
             pipeline.make_batch(cfg, base.ShapeConfig("t", "train", 32, 2), 0).items()}
    step = trainer.make_train_step(cfg, adamw.AdamWConfig(total_steps=3, warmup_steps=1))
    runs = []
    for _ in range(2):
        state = trainer.train_state_init(None, cfg, params=lm_params(host, cfg, device="cpu"))
        grads = torch.autograd.grad(transformer.loss_fn(state.params, batch, cfg),
                                    list(transformer._leaves(state.params)))
        state, m = step(state, batch)
        runs.append([m["loss"], *grads, *transformer._leaves(state.params),
                     *transformer._leaves(state.opt_state)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_zamba2_prefill_writes_the_shared_cache_in_place():
    """The shared block's k/v land in the preallocated (n_groups, B,
    max_len, K, hd) cache (slots past the prompt stay zero), and a prompt
    longer than the cache raises."""
    cfg = _cfg()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
    _, state = transformer.prefill(params, {"tokens": toks}, cfg, max_len=16)
    ng = transformer.attention_layers(cfg)
    assert ng == cfg.n_layers // cfg.shared_attn_every == 2
    kv = state["shared_kv"]
    assert tuple(kv["k"].shape) == (ng, 2, 16, cfg.n_kv_heads, cfg.head_dim_)
    assert kv["k"][:, :, :9].abs().amax(dim=(1, 2, 3, 4)).min() > 0
    assert not kv["k"][:, :, 9:].any() and not kv["v"][:, :, 9:].any()
    assert tuple(state["mamba"]["ssm"].shape)[:2] == (cfg.n_layers, 2)
    with pytest.raises(ValueError, match="does not fit"):
        transformer.prefill(params, {"tokens": toks}, cfg, max_len=8)


def test_flash_head_dim_80():
    """zamba2-2.7b's head dim (2560 / 32 = 80): the plain version runs for
    CPU tensors in both directions; aligned bf16 routes to wgmma (forward
    and backward), an unaligned bf16 view to the mma_sync forward; the fma
    route (float32) refuses D = 80 naming the routes that take it."""
    assert base.get_config("zamba2-2.7b").head_dim_ == 80
    assert 80 in flash_ops.SUPPORTED_D and 80 in flash_ops.BWD_D
    assert 80 in flash_ops.WGMMA_D and 80 not in flash_ops.FMA_D
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 9, 4, 80), generator=gen) for _ in range(3))
    flash_ops.reset_counts()
    o = flash_ops.flash_attention(q, k, v)
    dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, o, torch.ones_like(o))
    assert dq.shape == q.shape and dk.shape == k.shape
    assert flash_ops.counts["flash_attention"].plain_calls == 1
    assert flash_ops.counts["flash_attention_bwd"].plain_calls == 1
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert flash_ops.route(qb, kb, vb) == flash_ops.bwd_route(qb, kb, vb) == "wgmma"
    qu = torch.zeros((1, 9, 4, 82), dtype=torch.bfloat16)[..., :80]  # rows 164 B apart
    assert flash_ops.route(qu, kb, vb) == "mma_sync"
    assert flash_ops.bwd_route(qu, kb, vb) == "wgmma"
    assert flash_ops.route(q, k, v) == "fma"
    with pytest.raises(ValueError, match="wgmma and mma_sync routes only"):
        flash_ops._check_fma("fma", 80, "flash_attention")
