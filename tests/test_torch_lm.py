"""The port's LM modules vs the reference on the same numpy-made inputs.

Reduced qwen3-1.7b in float32 (2 layers, d_model 64, 4 query heads over 2
KV heads, head_dim 16), with the reference's parameters carried across by
``repro_torch.convert.lm_params``.  Tolerances, float32 throughout:

* norms, RoPE, MLP: rtol 1e-5 / atol 1e-6 (same arithmetic, other
  summation order);
* attention and model logits: max |port - reference| <= 1e-4 of the
  largest |reference| value (the serve tolerance of chip_smoke.py; the two differ
  by f32 rounding in matmuls and the softmax);
* KV caches: the same 1e-4 of max |reference|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import rope as ref_rope
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.convert import lm_params
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention, common, rope, transformer

REL = 1e-4


def _cfg(**kw):
    return dataclasses.replace(base.get_reduced("qwen3-1.7b"), dtype="float32", **kw)


def _ref_cfg(cfg):
    return ref_base.ArchConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rel=REL):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_config_is_the_references():
    for name in ("qwen3-1.7b", "qwen3_17b"):
        assert dataclasses.asdict(base.get_config(name)) == dataclasses.asdict(
            ref_base.get_config(name))
        assert dataclasses.asdict(base.get_reduced(name)) == dataclasses.asdict(
            ref_base.get_reduced(name))
    assert base.ARCH_IDS == ref_base.ARCH_IDS and base.ALIASES == ref_base.ALIASES


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "xlstm_125m", "qwen2-vl-7b", "elasticity"])
def test_unported_arch_raises(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        base.get_config(arch)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        base.get_config("gpt-2")


@pytest.mark.parametrize("change", [
    {"n_experts": 4, "top_k": 2},
    {"block_pattern": "mamba2"},
    {"pos_embed": "sinusoidal"},
    {"n_codebooks": 4},
])
def test_unported_family_raises(change):
    cfg = _cfg(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_decode_state(cfg, 1, 8)


def test_training_path_raises():
    """The training path of a family that is not ported raises, naming
    ROADMAP.md; the dense family's is held against the reference in
    tests/test_torch_train.py."""
    cfg = _cfg(n_experts=4, top_k=2)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "labels": torch.zeros((1, 8), dtype=torch.long)}
    params = transformer.init_params(torch.Generator().manual_seed(0), _cfg())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.loss_fn(params, batch, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.forward(params, batch, cfg)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    ref = ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    np.testing.assert_allclose(common.rmsnorm(_t(x), _t(s), 1e-6).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    # bf16 in, bf16 out, accumulated in f32
    xb = common.rmsnorm(_t(x).bfloat16(), _t(s).bfloat16())
    refb = ref_common.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16))
    assert xb.dtype == torch.bfloat16
    np.testing.assert_allclose(xb.float().numpy(), np.asarray(refb, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    ref = ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(rope.apply_rope(_t(x), _t(pos), 1e6).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rope.rope_frequencies(16, 1e6).numpy(),
                               ref_rope.rope_frequencies(16, 1e6), rtol=1e-6)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_apply(mlp_type):
    p = _np_tree(ref_common.mlp_init(jax.random.PRNGKey(2), 32, 48, mlp_type, jnp.float32))
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    ref = ref_common.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), mlp_type)
    out = common.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), mlp_type)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_dense_init_is_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = common.dense_init(g, (256, 512), torch.float32)
    sigma = 1 / 16
    assert float(w.abs().max()) <= 2 * sigma
    # a unit normal cut at +-2 has std 0.8796
    assert abs(float(w.std()) / sigma - 0.8796) < 0.01
    again = common.dense_init(torch.Generator().manual_seed(0), (256, 512), torch.float32)
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 8])
def test_attention_matches_full_and_chunked(window):
    cfg = _cfg(sliding_window=window)
    rcfg = _ref_cfg(cfg)
    p = _np_tree(ref_attention.attn_init(jax.random.PRNGKey(3), rcfg, jnp.float32))
    S = 64
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    flash_ops.reset_counts()
    out, (k, v) = attention.attention({n: _t(a) for n, a in p.items()}, _t(x), cfg,
                                      _t(pos.copy()))
    assert flash_ops.counts["flash_attention"].plain_calls == 1
    jp = jax.tree.map(jnp.asarray, p)
    for impl, kw in (("full", {}), ("chunked", {"q_chunk": 16, "k_chunk": 16})):
        ref, (rk, rv) = ref_attention.attention(jp, jnp.asarray(x), rcfg, jnp.asarray(pos),
                                                impl=impl, **kw)
        _close(out, ref)
        _close(k, rk)
        _close(v, rv)


# ---------------------------------------------------------------------------
# model: parameters, prefill, decode
# ---------------------------------------------------------------------------
def test_lm_params_round_trip():
    """Reference init (its own dtype, bfloat16) -> numpy -> port: every
    tensor equal in shape and value."""
    cfg = base.get_reduced("qwen3-1.7b")
    ref = _np_tree(ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    port = lm_params(ref, cfg, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(ref_leaves) == len(list(transformer._leaves(port)))
    for path, a in ref_leaves:
        t = port
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_lm_params_rejects_wrong_structure():
    cfg = _cfg()
    ref = _np_tree(ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    bad = dict(ref, embed=ref["embed"][:, :8])
    with pytest.raises(ValueError, match="embed has shape"):
        lm_params(bad, cfg, device="cpu")
    bad = {k: v for k, v in ref.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        lm_params(bad, cfg, device="cpu")


def test_init_params_layout():
    cfg = _cfg()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    shapes = transformer._tree_map(lambda a: tuple(a.shape), params)
    assert shapes == transformer.param_shapes(cfg)
    ref = _np_tree(ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
    assert shapes == jax.tree.map(lambda a: a.shape, ref)
    assert all(t.dtype == torch.float32 for t in transformer._leaves(params))
    assert transformer.param_count(params) == ref_tf.param_count(ref)


def _models(cfg, seed=0):
    rcfg = _ref_cfg(cfg)
    ref = ref_tf.init_params(jax.random.PRNGKey(seed), rcfg)
    return rcfg, ref, lm_params(_np_tree(ref), cfg, device="cpu")


@pytest.mark.parametrize("window,S,max_len", [(None, 12, 20), (8, 12, 20), (8, 6, 20)])
def test_prefill_and_decode_match_reference(window, S, max_len):
    """window=8 with S=12 prefills past the window (the rolling cache's
    slot = pos % size layout); S=6 stays inside it."""
    cfg = _cfg(sliding_window=window)
    rcfg, ref, port = _models(cfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, S + 3)).astype(np.int32)
    logits, state = transformer.prefill(port, {"tokens": _t(toks[:, :S]).long()}, cfg,
                                        max_len=max_len)
    rlogits, rstate = ref_tf.prefill(ref, {"tokens": jnp.asarray(toks[:, :S])}, rcfg,
                                     max_len=max_len)
    _close(logits, rlogits)
    for name in ("k", "v"):
        assert tuple(state[name].shape) == rstate[name].shape
        _close(state[name], rstate[name])
    for t in range(3):
        pos = S + t
        logits, state = transformer.decode_step(port, _t(toks[:, pos:pos + 1]).long(), state,
                                                pos, cfg)
        rlogits, rstate = ref_tf.decode_step(ref, jnp.asarray(toks[:, pos:pos + 1]), rstate,
                                             jnp.int32(pos), rcfg)
        _close(logits, rlogits)
        for name in ("k", "v"):
            _close(state[name], rstate[name])


def test_multi_step_decode_matches_forward():
    """Decoding T tokens step by step == forward over the full sequence
    (the port alone, as tests/test_decode.py checks the reference)."""
    cfg = _cfg()
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    S, T = 16, 4
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, S)).astype(np.int64))
    _, state = transformer.prefill(params, {"tokens": toks[:, : S - T]}, cfg, max_len=S + 4)
    hidden, _ = transformer.forward(params, {"tokens": toks}, cfg)
    w = params["embed"].T
    for t in range(T):
        pos = S - T + t
        logits, state = transformer.decode_step(params, toks[:, pos:pos + 1], state, pos, cfg)
        ref = hidden[:, pos] @ w
        err = float((logits - ref).abs().max() / (ref.abs().max() + 1e-9))
        assert err < 1e-5, f"step {t}: rel err {err}"


def test_prefill_rejects_overlong_prompt():
    cfg = _cfg()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="does not fit"):
        transformer.prefill(params, {"tokens": torch.zeros((1, 9), dtype=torch.long)}, cfg,
                            max_len=8)
