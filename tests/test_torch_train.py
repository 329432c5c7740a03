"""The port's training slice against the reference, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
reference's parameters are carried across with ``repro_torch.convert``.
Tolerances, float32 throughout:

* the data pipeline: bitwise (both are numpy);
* ``cosine_schedule`` and ``adamw_update``: 1e-6 of max |reference| (the
  same f32 arithmetic, XLA's and PyTorch's pow/sqrt);
* ``flash_bwd_ref``: 1e-5 of max |reference| against ``torch.autograd`` of
  ``flash_ref`` and ``jax.vjp`` of the reference's attention paths (f32
  matmuls in another order);
* ``loss_fn`` and every gradient leaf of each ported architecture's
  reduced configuration: 1e-4 of max |reference| (the model tolerance of
  ``tests/test_torch_lm.py``);
* three ``train_step`` losses: 1e-4 relative;
* the CLI's kill/resume: bitwise against the uninterrupted run.  Its
  processes run PyTorch on one CPU thread: with the default intra-op
  threads one loss of a run differs by about an ulp in about one run of
  three, also without a restart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data import pipeline as ref_pipeline
from repro.models import attention as ref_attention
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base
from repro_torch.convert import lm_params, train_state
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_ref
from repro_torch.launch.train import train_loop
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
CFG = dataclasses.replace(base.get_reduced("qwen3-1.7b"), dtype="float32")


def _ref_cfg(cfg):
    return ref_base.ArchConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rel):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, list):  # the xLSTM's list of blocks
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# configuration and data
# ---------------------------------------------------------------------------
def test_shapes_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    assert (base.SHAPES["train_4k"].seq_len, base.SHAPES["train_4k"].global_batch) == (4096, 256)


@pytest.mark.parametrize("seed,step,shard,codebooks", [
    (0, 0, None, 0), (3, 7, None, 0), (1, 2, (1, 2), 0), (5, 11, (3, 4), 0), (2, 4, None, 4),
])
def test_make_batch_is_the_references_bitwise(seed, step, shard, codebooks):
    cfg = dataclasses.replace(CFG, n_codebooks=codebooks)
    shape = base.ShapeConfig("t", "train", 32, 8)
    got = pipeline.make_batch(cfg, shape, step, seed, shard)
    want = ref_pipeline.make_batch(_ref_cfg(cfg), ref_base.ShapeConfig("t", "train", 32, 8),
                                   step, seed, shard)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    rows = 8 // (shard[1] if shard else 1)
    assert {k: ((8,) + got[k].shape[1:], got[k].dtype, len(got[k])) for k in got} == {
        k: (s, d, rows) for k, (s, d) in pipeline.batch_shapes(cfg, shape).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_shapes_refuse_vision(dtype):
    """Vision batches (once refused) are the reference's bitwise: the
    vision prefix's labels masked, the embeddings drawn from their own
    seed; a bfloat16 configuration's embeddings come as float32 arrays that
    hold the reference's bfloat16 values exactly."""
    cfg = dataclasses.replace(base.get_reduced("qwen2-vl-7b"), dtype=dtype)
    shape = base.ShapeConfig("t", "train", 16, 4)
    for step, shard in ((0, None), (3, (1, 2))):
        got = pipeline.make_batch(cfg, shape, step, 5, shard)
        want = ref_pipeline.make_batch(_ref_cfg(cfg), ref_base.ShapeConfig("t", "train", 16, 4),
                                       step, 5, shard)
        assert list(got) == list(want)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert (got["labels"][:, :cfg.n_vision_tokens] == -1).all()
        v = got["vision_embeds"]
        assert v.dtype == np.float32 and v.shape == want["vision_embeds"].shape
        np.testing.assert_array_equal(v.view(np.uint32),
                                      want["vision_embeds"].astype(np.float32).view(np.uint32))
        assert {k: (s[1:], d) for k, (s, d) in pipeline.batch_shapes(cfg, shape).items()} == {
            k: (a.shape[1:], a.dtype) for k, a in got.items()}
    # the rounding on every kind of float32 bit pattern that is finite,
    # ties included, against numpy's own bfloat16 (ml_dtypes, which jax uses)
    bits = np.random.default_rng(0).integers(0, 2**32, 200_000, dtype=np.uint32)
    bits[:1000] = (bits[:1000] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)  # exact ties
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < 3e38)]
    np.testing.assert_array_equal(pipeline._round_to_bfloat16(x).view(np.uint32),
                                  x.astype(jnp.bfloat16).astype(np.float32).view(np.uint32))


def test_pipeline_resume_is_bitwise():
    shape = base.ShapeConfig("t", "train", 16, 4)
    p = pipeline.TokenPipeline(CFG, shape, seed=2)
    first = [next(p) for _ in range(5)]
    sd = p.state_dict()
    p.close()
    assert sd == {"step": 5, "seed": 2}
    resumed = pipeline.TokenPipeline(CFG, shape, seed=0)
    resumed.load_state_dict({"step": 3, "seed": 2})
    again = [next(resumed) for _ in range(2)]
    resumed.close()
    ref = ref_pipeline.TokenPipeline(_ref_cfg(CFG), ref_base.ShapeConfig("t", "train", 16, 4),
                                     seed=2)
    want = [next(ref) for _ in range(5)]
    ref.close()
    for got, w in zip(first, want):
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
    for got, w in zip(again, first[3:]):
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)


def test_cosine_schedule_matches_reference():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 500]
    cfg = dataclasses.replace(OPT)
    got = [float(adamw.cosine_schedule(cfg, s)) for s in steps]
    want = [float(ref_adamw.cosine_schedule(ref_adamw.AdamWConfig(**dataclasses.asdict(cfg)), s))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(want))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below and above clip_norm
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 6)).astype(np.float32),
              "blocks": {"norm": rng.standard_normal((6,)).astype(np.float32),
                         "u": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: (grad_scale * rng.standard_normal(a.shape)).astype(np.float32),
                          params) for _ in range(3)]
    rcfg = ref_adamw.AdamWConfig(**dataclasses.asdict(OPT))
    rp = jax.tree.map(jnp.asarray, params)
    ropt = ref_adamw.adamw_init(rp)
    tp = jax.tree.map(_t, params)
    topt = adamw.adamw_init(tp)
    for g in grads:
        rp, ropt, rm = ref_adamw.adamw_update(rcfg, rp, jax.tree.map(jnp.asarray, g), ropt)
        tp, topt, tm = adamw.adamw_update(OPT, tp, jax.tree.map(_t, g), topt)
        for k in ("grad_norm", "lr"):
            _close(tm[k], rm[k], 1e-6)
    for path, a in _paths(tp):
        _close(a, _get(rp, path), 1e-6)
        _close(_get(topt["m"], path), _get(ropt["m"], path), 1e-6)
        _close(_get(topt["v"], path), _get(ropt["v"], path), 1e-6)
    assert int(topt["step"]) == int(ropt["step"]) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_by_slices_is_bitwise_the_whole_leafs(dtype, monkeypatch):
    """A leaf above SLICE_ELEMS is updated in chunks of its leading axis
    (one layer of a stacked leaf; several rows of an embedding): parameters
    and moments bitwise those of the whole-leaf update, weight decay still
    decided by the leaf's ndim (a stacked (L, d) norm decays, as in the
    reference)."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 40, 30), generator=g).to(dtype),
              "norm": torch.randn((3, 16), generator=g).to(dtype),
              "embed": torch.randn((25, 4), generator=g).to(dtype),
              "b": torch.randn((20,), generator=g).to(dtype)}
    grads = [{k: torch.randn(v.shape, generator=g).to(dtype) for k, v in params.items()}
             for _ in range(3)]
    out = []
    for limit in (adamw.SLICE_ELEMS, 10):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", limit)
        p = {k: v.clone() for k, v in params.items()}
        opt = adamw.adamw_init(p)
        for gr in grads:
            adamw.adamw_update(OPT, p, gr, opt)
        out.append([p[k] for k in p] + [opt[n][k] for n in ("m", "v") for k in p])
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---------------------------------------------------------------------------
# the flash backward's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G,window", [(1, None), (2, None), (1, 8), (2, 8)])
def test_flash_bwd_ref_matches_autograd_and_reference_vjp(G, window):
    rng = np.random.default_rng(G * 10 + (window or 0))
    B, S, K, D = 2, 32, 2, 16
    q, do = (rng.standard_normal((B, S, K * G, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = flash_ref(tq, tk, tv, window=window)
    auto = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    got = flash_bwd_ref(_t(q), _t(k), _t(v), o.detach(), _t(do), window=window)
    for a, g in zip(auto, got):
        _close(g, a.numpy(), 1e-5)
    for impl in (lambda q, k, v: ref_attention._full_attention(q, k, v, window),
                 lambda q, k, v: ref_attention._chunked_attention(q, k, v, window, 8, 8)):
        _, vjp = jax.vjp(impl, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for want, g in zip(vjp(jnp.asarray(do)), got):
            _close(g, want, 1e-5)


def test_flash_attention_autograd_on_cpu_runs_the_plain_backward():
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((1, 20, 4, 16)).astype(np.float32)).requires_grad_(True)
    k = _t(rng.standard_normal((1, 20, 2, 16)).astype(np.float32)).requires_grad_(True)
    v = _t(rng.standard_normal((1, 20, 2, 16)).astype(np.float32)).requires_grad_(True)
    do = _t(rng.standard_normal((1, 20, 4, 16)).astype(np.float32))
    flash_ops.reset_counts()
    o = flash_ops.flash_attention(q, k, v, window=5)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = flash_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do, window=5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts = {n: (c.launches, c.plain_calls) for n, c in flash_ops.counts.items()}
    assert counts == {"flash_attention": (0, 1), "flash_attention_bwd": (0, 1)}
    with torch.no_grad():  # inference: the forward alone, nothing saved
        assert flash_ops.flash_attention(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match=r"instantiated for D in \(16, 32, 64, 80, 128\)"):
        x = torch.zeros((1, 4, 2, 8))
        flash_ops.flash_attention_bwd(x, x, x, x, x)


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------
def _models(cfg, seed=0):
    rcfg = _ref_cfg(cfg)
    ref = ref_tf.init_params(jax.random.PRNGKey(seed), rcfg)
    port = lm_params(_np_tree(ref), cfg, device="cpu")
    for _, a in _paths(port):
        a.requires_grad_(True)
    return rcfg, ref, port


def _reduced(arch):
    return dataclasses.replace(base.get_reduced(arch), dtype="float32")


# The reference's loss and gradients as one compiled program (op-by-op
# dispatch compiles each primitive at each shape, about twice the time).
_ref_value_and_grad = jax.jit(jax.value_and_grad(ref_tf.loss_fn), static_argnums=(2,),
                              static_argnames=("remat",))


# qwen3-1.7b's cases keep their ids; every other ported architecture's
# reduced configuration with and without remat
LOSS_CASES = [pytest.param("qwen3_17b", r, id=str(r)) for r in (True, False)]
LOSS_CASES += [pytest.param(a, r, id=f"{a}-{r}") for a in base.PORTED if a != "qwen3_17b"
               for r in (True, False)]


@pytest.mark.parametrize("arch,remat", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, remat):
    """The VLM's batch carries vision embeddings (its labels mask their
    positions); musicgen's CE is averaged over its 4 codebooks' heads."""
    cfg = _reduced(arch)
    rcfg, ref, port = _models(cfg)
    shape = base.ShapeConfig("t", "train", 64, 2)
    batch = pipeline.make_batch(cfg, shape, 1)
    rloss, rgrads = _ref_value_and_grad(ref, jax.tree.map(jnp.asarray, batch), rcfg, remat=remat)
    flash_ops.reset_counts()
    loss = transformer.loss_fn(port, {k: _t(v) for k, v in batch.items()}, cfg, remat=remat)
    leaves = [a for _, a in _paths(port)]
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, rloss, REL)
    for (path, _), g in zip(_paths(port), grads):
        _close(g, _get(rgrads, path), REL)
    # every attention block through the flash path (zamba2: one a group),
    # again in the recompute under remat; one backward a block
    n = transformer.attention_layers(cfg)
    assert (flash_ops.counts["flash_attention"].plain_calls,
            flash_ops.counts["flash_attention_bwd"].plain_calls) == (n * (2 if remat else 1), n)


def test_chunked_ce_loss_over_several_chunks_matches_reference():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 48, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(-1, 40, (2, 48)).astype(np.int32)
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    got = transformer.chunked_ce_loss(th, tw, _t(labels), chunk=16)
    gh, gw = torch.autograd.grad(got, (th, tw))
    want, (rh, rw) = jax.value_and_grad(ref_tf.chunked_ce_loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), 16)
    _close(got, want, 1e-6)
    _close(gh, rh, 1e-5)
    _close(gw, rw, 1e-5)
    with pytest.raises(ValueError, match="not a multiple"):
        transformer.chunked_ce_loss(th, tw, _t(labels), chunk=20)


def test_loss_above_loss_chunk_matches_reference():
    """S = 2 * LOSS_CHUNK: the CE runs two chunks, the reference's
    attention its chunked path."""
    cfg = dataclasses.replace(CFG, n_layers=1)
    rcfg, ref, port = _models(cfg, seed=2)
    shape = base.ShapeConfig("t", "train", 2 * transformer.LOSS_CHUNK, 1)
    batch = pipeline.make_batch(cfg, shape, 0)
    rloss = ref_tf.loss_fn(ref, jax.tree.map(jnp.asarray, batch), rcfg)
    with torch.no_grad():
        loss = transformer.loss_fn(port, {k: _t(v) for k, v in batch.items()}, cfg)
    _close(loss, rloss, REL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", base.PORTED)
def test_three_train_steps_match_reference(arch):
    """Each step's loss, grad norm and lr, and the final AdamW moments, to
    REL; the final parameters to REL of a leaf's max |reference|.

    AdamW moves an element by lr x m/(sqrt(v) + eps), about lr x g/(|g| +
    eps) at the first step: for |g| near eps = 1e-8 the step turns on the
    gradient's last digits, which f32 (and the reference's x64 scalars
    under tests/conftest.py) round differently, and two exact ports differ
    by up to lr there.  Such gradients are rounding noise: the key bias
    under qkv_bias is nearly shift-invariant under the softmax.  So, beside
    the moments held whole, the other architectures hold their parameters
    on the elements whose clipped gradient, recovered from the reference's
    first moment at each step, is 0 or above 100 eps (over 99% of every
    weight matrix; 60% of bk); qwen3-1.7b holds every element, as
    before."""
    cfg = _reduced(arch)
    rcfg = _ref_cfg(cfg)
    opt = adamw.AdamWConfig(total_steps=3, warmup_steps=1)
    rstate = ref_trainer.train_state_init(jax.random.PRNGKey(0), rcfg)
    state = train_state(_np_tree(rstate), cfg, device="cpu")
    rstep = jax.jit(ref_trainer.make_train_step(rcfg, ref_adamw.AdamWConfig(
        **dataclasses.asdict(opt))))
    step = trainer.make_train_step(cfg, opt)
    shape = base.ShapeConfig("t", "train", 32, 2)
    noise = {path: False for path, _ in _paths(state.params)}
    for i in range(3):
        batch = pipeline.make_batch(cfg, shape, i)
        m_before = _np_tree(rstate.opt_state["m"])
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], rm[k], REL)
        assert all(p.grad is None for _, p in _paths(state.params))
        for path in noise:
            g = (np.asarray(_get(rstate.opt_state["m"], path))
                 - opt.beta1 * _get(m_before, path)) / (1 - opt.beta1)
            noise[path] = noise[path] | ((np.abs(g) <= 100 * opt.eps) & (g != 0))
    assert int(state.step) == int(rstate.step) == 3
    for path, a in _paths(state.params):
        for name in ("m", "v"):
            _close(_get(state.opt_state[name], path), _get(rstate.opt_state[name], path), REL)
        want = np.asarray(_get(rstate.params, path))
        keep = np.ones(want.shape, bool) if arch == "qwen3_17b" else ~noise[path]
        err = float(np.abs(a.detach().numpy() - want)[keep].max(initial=0.0))
        assert err <= REL * float(np.abs(want).max()), (path, err, float(keep.mean()))


def test_train_state_carries_the_references():
    rcfg = _ref_cfg(CFG)
    rstate = _np_tree(ref_trainer.train_state_init(jax.random.PRNGKey(1), rcfg))
    state = train_state(rstate, CFG, device="cpu")
    for path, a in _paths(state.params):
        assert a.requires_grad and a.dtype == torch.float32
        np.testing.assert_array_equal(a.detach().numpy(), _get(rstate.params, path))
    for name in ("m", "v"):
        for path, a in _paths(state.opt_state[name]):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), _get(rstate.opt_state[name], path))
    assert state.step.dtype == torch.int32 and int(state.step) == 0


def test_profiled_last_step_is_the_state_returned_and_saved(tmp_path, capsys):
    """With ``profile``, the last step runs under the profiler: it is logged
    and checkpointed, and the state returned is the state saved."""
    shape = base.ShapeConfig("t", "train", 16, 2)
    state, history = train_loop(CFG, shape, steps=2, ckpt_dir=str(tmp_path), ckpt_every=1,
                                log_every=1, device="cpu", profile=True)
    assert "[profile] train.step" in capsys.readouterr().out
    assert [m["step"] for m in history] == [1, 2] and int(state.step) == 2
    saved, _, step = CheckpointManager(str(tmp_path)).restore_latest(
        trainer.train_state_init(torch.Generator().manual_seed(1), CFG))
    assert step == 2 and int(saved.step) == 2
    for path, a in _paths(state.params):
        torch.testing.assert_close(a.detach(), _get(saved.params, path), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the CLI: kill and resume
# ---------------------------------------------------------------------------
def _cli(tmp_path, *extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
           "--steps", "6", "--ckpt-every", "3", "--log-every", "1", "--seq", "32",
           "--batch", "2", *extra]
    return subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)


_STEP = re.compile(r"\[train\] step +(\d+) loss (\S+) gnorm (\S+) lr (\S+) .* tokens crc32 (\S+)")


def _steps(out):
    """step -> (loss, grad norm, lr, the batch's crc32) of each logged step
    (not its timings)."""
    return {int(m[1]): m.groups()[1:] for m in map(_STEP.match, out.splitlines()) if m}


def test_cli_kill_and_resume_is_bitwise(tmp_path):
    a = _cli(tmp_path, "--ckpt-dir", "a")
    assert a.returncode == 0, a.stderr[-2000:]
    b = _cli(tmp_path, "--ckpt-dir", "b", "--kill-after-steps", "4")
    assert b.returncode == -9, b.stderr[-2000:]
    c = _cli(tmp_path, "--ckpt-dir", "b")
    assert c.returncode == 0 and "resumed from checkpoint step 3" in c.stdout, c.stderr[-2000:]
    la, lb, lc = _steps(a.stdout), _steps(b.stdout), _steps(c.stdout)
    assert sorted(la) == [1, 2, 3, 4, 5, 6] and sorted(lb) == [1, 2, 3, 4]
    assert sorted(lc) == [4, 5, 6]

    assert all(la[s] == lb[s] for s in lb) and all(la[s] == lc[s] for s in lc)
    ma, mc = (json.load(open(tmp_path / d / "step_000000006" / "manifest.json")) for d in "ab")
    assert [(e["path"], e["crc32"]) for e in ma["leaves"]] == [
        (e["path"], e["crc32"]) for e in mc["leaves"]]
