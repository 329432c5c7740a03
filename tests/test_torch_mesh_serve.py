"""Prefill and decode on a mesh of virtual CPU devices
(``mesh_prefill``/``mesh_decode_step``) against the unsharded port and the
reference, and training with a batch split over both mesh axes.

Reduced configurations in float32 on one PyTorch thread; B = 4 prompts of
16 tokens, 8 decode steps teacher-forced on the unsharded run's greedy
tokens.  Besides qwen3, olmoe, zamba2 and xlstm, the serving branches that
those leave out: mixtral with its window cut to 8, below the prompt, so
that its cache of 8 slots rolls in prefill and in decode; qwen2-vl (M-RoPE
and vision embeddings); musicgen (sinusoidal positions and codebooks).
Tolerances:

* a (1, 1) mesh: bitwise the unsharded ``prefill``/``decode_step``;
* (2, 1), (1, 2) and (2, 2): every step's logits within 1e-5 of max
  |logit| of the unsharded ones (tensor parallelism sums a projection's
  halves, and the sequence-split cache's partial softmaxes are combined
  by log-sum-exp, in another order than one softmax), and the 8 greedy
  tokens equal;
* the sequence-split cache after prefill: within 1e-6 of the whole cache;
  one layer's decode attention on it within 1e-5 of ``decode_attention``
  on the whole cache;
* (2, 2) against the reference's ``prefill`` and ``decode_step`` on the
  same parameters: 1e-4 of max |logit|, as the unsharded port.
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
from repro_torch.configs import base
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed.sharding import P, gather, param_pspecs, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention
from repro_torch.models import transformer as tf

ARCHS = ["qwen3_17b", "olmoe_1b_7b", "zamba2_27b", "xlstm_125m"]
SERVE_ARCHS = ARCHS + ["mixtral_8x7b", "qwen2_vl_7b", "musicgen_medium"]
MESHES = [(2, 1), (1, 2), (2, 2)]
B, S, NEW = 4, 16, 8
WINDOW = 8  # mixtral's sliding window here: its cache of 8 slots rolls
TOL, REF_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    cfg = dataclasses.replace(base.get_reduced(arch), dtype="float32")
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    return cfg


def _mesh(dm):
    return make_local_mesh(dm[1], devices=("cpu",) * (dm[0] * dm[1]))


_SETUP: dict = {}


def _setup(arch):
    """The port's seeded parameters (seed 0) and the prompts (seed 1; a
    VLM's vision embeddings too)."""
    if arch not in _SETUP:
        cfg = _cfg(arch)
        params = tf.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(1)
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32))}
        if cfg.n_vision_tokens:
            batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
        _SETUP[arch] = (params, batch)
    return _SETUP[arch]


def _serve(arch, mesh=None, forced=None):
    """Prefill, then NEW decode steps fed the greedy tokens (or
    ``forced``'s); returns every step's logits and the tokens fed."""
    params, batch = _setup(arch)
    cfg = _cfg(arch)
    with torch.no_grad():
        if mesh is None:
            logits, state = tf.prefill(params, batch, cfg, max_len=S + NEW)
        else:
            params = place(params, param_pspecs(params, mesh), mesh)
            logits, state = tf.mesh_prefill(params, batch, cfg, mesh, S + NEW)
        out, fed = [logits], []
        for i in range(NEW):
            tok = (forced[i] if forced is not None else logits.argmax(-1))[:, None]
            fed.append(tok[:, 0])
            if mesh is None:
                logits, state = tf.decode_step(params, tok, state, S + i, cfg)
            else:
                logits, state = tf.mesh_decode_step(params, tok, state, S + i, cfg, mesh)
            out.append(logits)
    return out, fed


_UNSHARDED: dict = {}


def _unsharded(arch):
    if arch not in _UNSHARDED:
        _UNSHARDED[arch] = _serve(arch)
    return _UNSHARDED[arch]


_ON_MESH: dict = {}


def _on_mesh(arch, dm):
    """Every step's logits on a ``dm`` mesh, teacher-forced on the
    unsharded run's greedy tokens."""
    if (arch, dm) not in _ON_MESH:
        _ON_MESH[arch, dm] = _serve(arch, _mesh(dm), forced=_unsharded(arch)[1])[0]
    return _ON_MESH[arch, dm]


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_one_by_one_mesh_is_bitwise_unsharded(arch):
    want, fed = _unsharded(arch)
    got, _ = _serve(arch, _mesh((1, 1)), forced=fed)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dm", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_serving_matches_unsharded(arch, dm):
    want, fed = _unsharded(arch)
    got = _on_mesh(arch, dm)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL
    if dm == (2, 2):
        # free-running greedy decode picks the same tokens: each step's
        # greedy token is the one fed next (the run is deterministic, so a
        # free run is this teacher-forced one until a token differs)
        assert all(torch.equal(g.argmax(-1), f) for g, f in zip(got, fed))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_matches_reference(arch):
    """(2, 2) against the reference's ``prefill`` and a ``decode_step`` (one
    jitted program), both fed the unsharded run's first greedy token, on the
    same parameters (the port's pytree is the reference's)."""
    params, batch = _setup(arch)
    cfg = _cfg(arch)
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    _, fed = _unsharded(arch)
    forced = jnp.asarray(fed[0].numpy().astype(np.int32))

    def run(p, tok, forced):
        logits, state = ref_tf.prefill(p, {"tokens": tok}, rcfg, max_len=S + NEW)
        return logits, ref_tf.decode_step(p, forced[:, None], state, S, rcfg)[0]

    ref = jax.jit(run)(tf._tree_map(lambda t: jnp.asarray(t.numpy()), params),
                       jnp.asarray(batch["tokens"].numpy()), forced)
    got = _on_mesh(arch, (2, 2))
    for g, r in zip(got, ref):
        assert _rel(g, torch.from_numpy(np.array(r))) <= REF_TOL


def test_sequence_split_cache_against_whole_cache():
    """qwen3 on (1, 2): the cache's positions split over ``model``; its
    blocks hold the whole cache's slices, and one layer's decode attention
    (partial softmaxes combined by log-sum-exp) is the whole cache's."""
    arch, mesh = "qwen3_17b", _mesh((1, 2))
    params, batch = _setup(arch)
    cfg = _cfg(arch)
    with torch.no_grad():
        _, whole = tf.prefill(params, batch, cfg, max_len=S + NEW)
        sp = place(params, param_pspecs(params, mesh), mesh)
        _, split = tf.mesh_prefill(sp, batch, cfg, mesh, S + NEW)
        assert split["k"].spec == P(None, "data", "model", None, None)
        assert [tuple(b.shape) for b in split["k"].blocks] == [(2, B, (S + NEW) // 2, 2, 16)] * 2
        for name in ("k", "v"):
            assert _rel(split[name].full("cpu"), whole[name]) <= 1e-6
        x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(2))
        layer = {k: v[0] for k, v in params["blocks"]["attn"].items()}
        want, _ = attention.decode_attention(layer, x, cfg,
                                             {n: whole[n][0].clone() for n in ("k", "v")}, S)
        sl = {k: v.unbind()[0] for k, v in sp["blocks"]["attn"].items()}
        got = attention.mesh_decode_attention(sl, [x, x], cfg, mesh,
                                              {n: split[n].unbind()[0] for n in ("k", "v")}, S)
    assert attention.attention_tp(sl, cfg, mesh)
    for g in got:
        assert _rel(g, want) <= TOL
    assert torch.equal(got[0], got[1])


def test_mesh_loss_takes_a_batch_split_over_both_axes():
    """The pure-DP layout of a small model: the batch's rows over (data,
    model), every device its own rows, the CE taken on every device."""
    cfg = _cfg("xlstm_125m")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    shape = base.ShapeConfig("t", "train", 16, 4)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, 0).items()}
    mesh = _mesh((2, 2))
    sp = place(params, param_pspecs(params, mesh, tp=False), mesh)
    sb = place(batch, {k: P(("data", "model"), None) for k in batch}, mesh)
    with torch.no_grad():
        want = tf.loss_fn(params, batch, cfg, remat=False)
        got = tf.loss_fn(sp, sb, cfg, remat=False, mesh=mesh)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    assert _rel(gather(sp, "cpu")["embed"], params["embed"]) == 0
