"""The port's LM modules vs the reference on the same numpy-made inputs.

Reduced qwen3-1.7b in float32 (2 layers, d_model 64, 4 query heads over 2
KV heads, head_dim 16), and every other ported architecture's reduced
configuration (granite-8b, qwen1.5-32b, qwen3-32b, qwen2-vl-7b with M-RoPE
and vision tokens, musicgen-medium with sinusoidal positions and 4
codebooks), with the reference's parameters carried across by
``repro_torch.convert.lm_params``.  Tolerances, float32 throughout:

* norms, RoPE, MLP: rtol 1e-5 / atol 1e-6 (same arithmetic, other
  summation order); M-RoPE and sinusoidal positions: 1e-6 of max
  |reference| (f32 sin/cos of the same angles);
* attention and model logits: max |port - reference| <= 1e-4 of the
  largest |reference| value (the serve tolerance of chip_smoke.py; the two differ
  by f32 rounding in matmuls and the softmax);
* KV caches: the same 1e-4 of max |reference|.
"""

import dataclasses
import math

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


def _cfg(arch="qwen3-1.7b", **kw):
    return dataclasses.replace(base.get_reduced(arch), dtype="float32", **kw)


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
ALIAS = {arch: alias for alias, arch in base.ALIASES.items()}


@pytest.mark.parametrize("arch", base.PORTED)
def test_config_is_the_references(arch):
    for name in (arch, ALIAS[arch]):
        assert dataclasses.asdict(base.get_config(name)) == dataclasses.asdict(
            ref_base.get_config(name))
        assert dataclasses.asdict(base.get_reduced(name)) == dataclasses.asdict(
            ref_base.get_reduced(name))
    assert base.ARCH_IDS == ref_base.ARCH_IDS and base.ALIASES == ref_base.ALIASES


@pytest.mark.parametrize("arch", ["xlstm-125m", "xlstm_125m", "elasticity"])
def test_unported_arch_raises(arch):
    """The ids that the registry once refused (the last LM architecture,
    by its alias and its id, and the solver's own configuration) now give
    the reference's configurations: ``elasticity``'s ``ElasticityConfig``
    and its reduced one, xlstm-125m's ``ArchConfig``s."""
    for get in ("get_config", "get_reduced"):
        got, want = getattr(base, get)(arch), getattr(ref_base, get)(arch)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        base.get_config("gpt-2")


@pytest.mark.parametrize("change", [
    {"block_pattern": "rwkv"},
])
def test_unported_family_raises(change):
    """An unknown block pattern raises ValueError, as the reference's
    init_params does (every pattern of the reference is ported)."""
    cfg = _cfg(**change)
    with pytest.raises(ValueError, match="rwkv"):
        ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg))
    with pytest.raises(ValueError, match="rwkv"):
        transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="rwkv"):
        transformer.init_decode_state(cfg, 1, 8)


def test_training_path_raises():
    """The training path of an unknown block pattern raises ValueError;
    every ported family's is held against the reference in
    tests/test_torch_train.py."""
    cfg = _cfg(block_pattern="rwkv")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "labels": torch.zeros((1, 8), dtype=torch.long)}
    params = transformer.init_params(torch.Generator().manual_seed(0), _cfg())
    with pytest.raises(ValueError, match="rwkv"):
        transformer.loss_fn(params, batch, cfg)
    with pytest.raises(ValueError, match="rwkv"):
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


def test_apply_mrope():
    """M-RoPE against the reference on (t, h, w) positions that differ
    (the VLM stub's grid), and equal to RoPE where all three agree."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 50, (3, 2, 12)).astype(np.int32)
    ref = np.asarray(ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (2, 3, 3)))
    got = rope.apply_mrope(_t(x), _t(pos3).long(), 1e6, (2, 3, 3)).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-6 * float(np.abs(ref).max())
    same = np.broadcast_to(pos3[:1], pos3.shape)
    np.testing.assert_array_equal(rope.apply_mrope(_t(x), _t(same).long(), 1e6, (2, 3, 3)),
                                  rope.apply_rope(_t(x), _t(pos3[0]).long(), 1e6))
    with pytest.raises(ValueError, match="sum to head_dim"):
        rope.apply_mrope(_t(x), _t(pos3).long(), 1e6, (2, 3, 2))


def test_sinusoidal_positions():
    """Against the reference to 1e-6 where the angle is small.  The angle is
    position x frequency in f32, and XLA's f32 exp gives 6 of the 32
    frequencies at d = 64 one ulp off the correctly rounded value that
    torch.exp gives; so at position p the two may differ by p ulps of the
    frequency (2**-23 for frequencies <= 1), which is the bound held at the
    larger positions."""
    pos = np.array([[0, 1, 7, 100, 2047]], np.int32)
    for d in (64, 1536):
        ref = np.asarray(ref_common.sinusoidal_positions(jnp.asarray(pos), d, jnp.float32))
        got = common.sinusoidal_positions(_t(pos).long(), d, torch.float32).numpy()
        assert got.shape == ref.shape == (1, 5, d)
        err = np.abs(got - ref).max(axis=-1)[0]
        assert (err[:3] <= 1e-6).all(), err
        assert (err <= 1e-6 + pos[0] * 2.0**-23).all(), err


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


def _stacked_init_before(generator, cfg):
    """init_params as it was before each stacked leaf was allocated once:
    every layer's tensors drawn, then stacked (kept here as the reference
    for the draws' order and values)."""
    dtype, dev = transformer.param_dtype(cfg), generator.device
    d, H, K, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff

    def draw(shape):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return ((1.0 / math.sqrt(shape[0])) * t).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    def layer():
        attn = {"wq": draw((d, H * hd)), "wk": draw((d, K * hd)), "wv": draw((d, K * hd)),
                "wo": draw((H * hd, d))}
        if cfg.qkv_bias:
            attn.update(bq=0 * ones(H * hd), bk=0 * ones(K * hd), bv=0 * ones(K * hd))
        if cfg.qk_norm:
            attn.update(q_norm=ones(hd), k_norm=ones(hd))
        if cfg.is_moe:  # the reference's moe_init: fan-in E for the experts
            E = cfg.n_experts
            return {"attn_norm": ones(d), "attn": attn, "mlp_norm": ones(d),
                    "moe": {"router": draw((d, E)), "w_gate": draw((E, d, f)),
                            "w_up": draw((E, d, f)), "w_down": draw((E, f, d))}}
        mlp = {"w_gate": draw((d, f))} if cfg.mlp_type == "swiglu" else {}
        mlp.update(w_up=draw((d, f)), w_down=draw((f, d)))
        return {"attn_norm": ones(d), "attn": attn, "mlp_norm": ones(d), "mlp": mlp}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params = {"embed": draw((cfg.vocab, d)),
              "blocks": stack([layer() for _ in range(cfg.n_layers)]), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((d, cfg.vocab))
    return params


def _with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, prefix + (k,))
    elif isinstance(tree, list):  # the xLSTM's list of blocks
        for i, v in enumerate(tree):
            yield from _with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", base.PORTED)
def test_init_params_allocates_once_and_draws_as_before(arch):
    """Every stacked leaf is its own (L,) + shape allocation, the layout is
    the reference's, and the draws are bitwise those of the stacking
    algorithm the port had before (both dtypes; qwen3-1.7b's seeded
    parameters therefore did not change)."""
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base.get_reduced(arch), dtype=dtype)
        params = transformer.init_params(torch.Generator().manual_seed(3), cfg)
        got = list(_with_paths(params))
        ref = _np_tree(ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))
        assert transformer._tree_map(lambda a: tuple(a.shape), params) == jax.tree.map(
            lambda a: a.shape, ref)
        assert len({t.untyped_storage().data_ptr() for _, t in got}) == len(got)
        # the codebook layout and zamba2's Mamba2 stack have no earlier algorithm
        if cfg.n_codebooks or cfg.block_pattern != "attn":
            continue
        want = list(_with_paths(_stacked_init_before(torch.Generator().manual_seed(3), cfg)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), path


def _models(cfg, seed=0):
    rcfg = _ref_cfg(cfg)
    ref = ref_tf.init_params(jax.random.PRNGKey(seed), rcfg)
    return rcfg, ref, lm_params(_np_tree(ref), cfg, device="cpu")


def _batch(cfg, toks, rng):
    """Port and reference batches of these tokens; the VLM's also carry
    vision embeddings (unit normal, from ``rng``)."""
    port, ref = {"tokens": _t(toks).long()}, {"tokens": jnp.asarray(toks)}
    if cfg.n_vision_tokens:
        v = rng.standard_normal((toks.shape[0], cfg.n_vision_tokens, cfg.d_model))
        port["vision_embeds"] = _t(v.astype(np.float32))
        ref["vision_embeds"] = jnp.asarray(v, jnp.float32)
    return port, ref


# qwen3-1.7b at three cache layouts (their ids as before), every other
# ported architecture with a dense cache, and mixtral-8x7b with its own
# window (32 at the reduced width) prefilled past it
PREFILL_CASES = [pytest.param("qwen3-1.7b", *c, id="-".join(map(str, c)))
                 for c in [(None, 12, 20), (8, 12, 20), (8, 6, 20)]]
PREFILL_CASES += [pytest.param(a, None, 12, 20, id=f"{a}-None-12-20")
                  for a in base.PORTED if a not in ("qwen3_17b", "mixtral_8x7b")]
PREFILL_CASES.append(pytest.param("mixtral_8x7b", 32, 40, 48, id="mixtral_8x7b-32-40-48"))


@pytest.mark.parametrize("arch,window,S,max_len", PREFILL_CASES)
def test_prefill_and_decode_match_reference(arch, window, S, max_len):
    """window=8 with S=12 prefills past the window (the rolling cache's
    slot = pos % size layout); S=6 stays inside it; mixtral-8x7b's window
    of 32 at S=40 as well.  zamba2-2.7b's state is its Mamba2 states and
    the shared block's k/v, held leaf by leaf.  The MoE architectures dispatch each prompt row
    at the capacity of S tokens and each decode step at that of one.  qwen2-vl-7b prefills
    with vision embeddings over its first 8 positions and decodes at
    M-RoPE's text positions; musicgen-medium takes (B, S, 4) codebook
    tokens and gives (B, 4, V) logits."""
    cfg = _cfg(arch, sliding_window=window)
    rcfg, ref, port = _models(cfg)
    rng = np.random.default_rng(4)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab, (2, S + 3) + cb).astype(np.int32)
    feed, rfeed = _batch(cfg, toks[:, :S], rng)
    logits, state = transformer.prefill(port, feed, cfg, max_len=max_len)
    rlogits, rstate = ref_tf.prefill(ref, rfeed, rcfg, max_len=max_len)
    assert tuple(logits.shape) == rlogits.shape == (2,) + cb + (cfg.vocab,)
    _close(logits, rlogits)
    _close_state(state, rstate)
    for t in range(3):
        pos = S + t
        logits, state = transformer.decode_step(port, _t(toks[:, pos:pos + 1]).long(), state,
                                                pos, cfg)
        rlogits, rstate = ref_tf.decode_step(ref, jnp.asarray(toks[:, pos:pos + 1]), rstate,
                                             jnp.int32(pos), rcfg)
        assert tuple(logits.shape) == rlogits.shape
        _close(logits, rlogits)
        _close_state(state, rstate)


def _key(key):
    """A jax path entry's dict key or sequence index."""
    return key.key if hasattr(key, "key") else key.idx


def _close_state(state, rstate):
    """Every leaf of a decode state (the KV cache's k/v; zamba2's Mamba2
    ssm/conv states and shared k/v; the xLSTM's list of per-layer states)
    to REL of its max |reference|, shapes equal, the leaves the
    reference's."""
    leaves = jax.tree_util.tree_leaves_with_path(rstate)
    assert len(leaves) == len(list(transformer._leaves(state)))
    for path, a in leaves:
        t = state
        for key in path:
            t = t[_key(key)]
        assert tuple(t.shape) == a.shape, path
        _close(t, a)


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
