"""Gradient compression and ``train_loop(compression=)`` against the
reference, on the CPU.

Inputs are made from a numpy seed.  Tolerances:

* ``int8_compress`` / ``int8_decompress`` and ``topk_compress``: bitwise
  in float32 (the same f32 max, division and round-half-to-even; top-k's
  threshold is the k-th largest |g| and every tie at it is kept);
* the error-feedback transform over 3 steps: 1e-7 of max |reference| for
  the compressed gradients and the residuals;
* ``train_loop`` with a compression callable, 3 steps of the reduced
  qwen3 from the reference's state: each step's loss and grad norm to 1e-4
  relative (the model tolerance of ``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.distributed import compression as ref_c
from repro.launch import train as ref_train
from repro.train import trainer as ref_trainer
from repro_torch.configs import base
from repro_torch.convert import train_state
from repro_torch.distributed import compression as c
from repro_torch.launch import train as port_train

REL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint8) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("shape,scale", [((7,), 1.0), ((33, 17), 3e-3), ((2, 5, 64), 40.0)])
def test_int8_compress_is_the_references_bitwise(shape, scale):
    g = (np.random.default_rng(len(shape)).standard_normal(shape) * scale).astype(np.float32)
    q, s = c.int8_compress(_t(g))
    rq, rs = ref_c.int8_compress(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(rs)))
    np.testing.assert_array_equal(_bits(c.int8_decompress(q, s).numpy()),
                                  _bits(np.asarray(ref_c.int8_decompress(rq, rs))))


def test_int8_rounds_half_to_even():
    """max |g| = 127 gives scale 1 (1e-12 vanishes in f32), so g / scale
    are exact halves: both packages round them to even."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    q, s = c.int8_compress(_t(g))
    rq, _ = ref_c.int8_compress(jnp.asarray(g))
    assert float(s) == 1.0
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, -2, 4])
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_compress_is_the_references_bitwise(frac):
    g = np.random.default_rng(3).standard_normal((40, 25)).astype(np.float32)
    out, mask = c.topk_compress(_t(g), frac)
    rout, rmask = ref_c.topk_compress(jnp.asarray(g), frac)
    assert mask.dtype == torch.bool and int(mask.sum()) == max(int(frac * g.size), 1)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(np.asarray(rout)))


def test_topk_keeps_every_tie_at_the_threshold():
    g = np.array([5.0, -5.0, 1.0, 5.0, 2.0, -3.0, 0.5], np.float32)
    out, mask = c.topk_compress(_t(g), 2 / 7)  # k = 2: the threshold is 5, held three times
    rout, rmask = ref_c.topk_compress(jnp.asarray(g), 2 / 7)
    np.testing.assert_array_equal(mask.numpy(), [True, True, False, True, False, False, False])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_error_feedback_over_three_steps_matches_reference(mode):
    rng = np.random.default_rng(7)
    shapes = {"w": (33, 17), "blocks": {"u": (2, 9, 4), "b": (5,)}}
    grads = [jax.tree.map(lambda sh: (rng.standard_normal(sh) * 1e-2).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    init, transform = c.make_error_feedback_transform(mode, frac=0.05)
    rinit, rtransform = ref_c.make_error_feedback_transform(mode, frac=0.05)
    res = init(jax.tree.map(_t, grads[0]))
    rres = rinit(jax.tree.map(jnp.asarray, grads[0]))
    for g in grads:
        comp, res = transform(jax.tree.map(_t, g), res)
        rcomp, rres = rtransform(jax.tree.map(jnp.asarray, g), rres)
        for got, want in ((comp, rcomp), (res, rres)):
            for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                            jax.tree.leaves(want)):
                b = np.asarray(b)
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
                assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max()
    with pytest.raises(ValueError):
        c.make_error_feedback_transform("fp8")


def test_train_loop_with_compression_matches_reference(monkeypatch):
    """Three steps of the reduced qwen3 through both ``train_loop``s, each
    given the same stateless int8 round trip as its ``compression``, the
    port from the reference's initial state."""
    cfg = dataclasses.replace(base.get_reduced("qwen3-1.7b"), dtype="float32")
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    shape = base.ShapeConfig("t", "train", 32, 2)
    rstate0 = jax.tree.map(np.asarray, ref_trainer.train_state_init(jax.random.PRNGKey(0), rcfg))

    def ref_int8(grads):
        return jax.tree.map(lambda g: ref_c.int8_decompress(*ref_c.int8_compress(g)).astype(
            g.dtype), grads)

    calls = []

    def port_int8(grads):
        calls.append(1)

        def one(tree):
            if isinstance(tree, dict):
                return {k: one(v) for k, v in tree.items()}
            return c.int8_decompress(*c.int8_compress(tree)).to(tree.dtype)

        return one(grads)

    _, want = ref_train.train_loop(rcfg, ref_base.ShapeConfig("t", "train", 32, 2), steps=3,
                                   compression=ref_int8, log_every=1)
    monkeypatch.setattr(port_train, "train_state_init",
                        lambda gen, cfg: train_state(rstate0, cfg, device="cpu"))
    state, got = port_train.train_loop(cfg, shape, steps=3, compression=port_int8, log_every=1,
                                       device="cpu")
    assert len(calls) == 3 and int(state.step) == 3
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= REL * abs(w[k]), (k, g[k], w[k])
