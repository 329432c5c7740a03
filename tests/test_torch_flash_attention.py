"""Port's flash-attention wrapper vs the reference Pallas kernel.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode and against the
reference's oracle ``flash_ref`` on the same numpy-made inputs: the shapes
of ``tests/test_flash_kernel.py`` (GQA, MHA, MQA), sliding windows
{16, 48, 128}, bfloat16 (f32 numpy inputs cast in both frameworks), and
ragged S (against ``flash_ref`` only: the reference kernel needs
S % block == 0).  Tolerances are those of ``tests/test_flash_kernel.py``:
atol 2e-5 in float32, 3e-2 in bfloat16 on unit-normal inputs.

The CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import flash_ref as ref_flash_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_ref

ATOL = {"f32": 2e-5, "bf16": 3e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [  # (B, S, H, K, D) of tests/test_flash_kernel.py
    (2, 128, 4, 2, 16),
    (1, 256, 8, 8, 32),  # MHA
    (2, 64, 8, 1, 8),  # MQA
    (1, 512, 4, 2, 64),
]


def _inputs(B, S, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, S, H, D)).astype(np.float32),
        rng.standard_normal((B, S, K, D)).astype(np.float32),
        rng.standard_normal((B, S, K, D)).astype(np.float32),
    )


def _port(arrays, dtype_name, window=None):
    tdt = DTYPES[dtype_name][1]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    before = (ops.counts["flash_attention"].launches, ops.counts["flash_attention"].plain_calls)
    o = ops.flash_attention(q, k, v, window=window)
    after = (ops.counts["flash_attention"].launches, ops.counts["flash_attention"].plain_calls)
    assert after == (before[0], before[1] + 1)  # the plain version ran
    assert o.dtype == tdt and o.shape == q.shape
    return o.float().numpy()


def _reference(arrays, dtype_name, window=None, kernel=True):
    jdt = DTYPES[dtype_name][0]
    q, k, v = (jnp.asarray(a).astype(jdt) for a in arrays)
    S = q.shape[1]
    outs = [ref_flash_ref(q, k, v, window=window)]
    if kernel:
        blk = min(64, S)
        outs.append(ref_flash_attention(q, k, v, window=window, block_q=blk,
                                        block_k=blk, interpret=True))
    return [np.asarray(o, np.float32) for o in outs]


@pytest.mark.parametrize("B,S,H,K,D", SHAPES)
def test_matches_reference_kernel(B, S, H, K, D):
    arrays = _inputs(B, S, H, K, D)
    o = _port(arrays, "f32")
    for ref in _reference(arrays, "f32"):
        np.testing.assert_allclose(o, ref, atol=ATOL["f32"])


@pytest.mark.parametrize("window", [16, 48, 128])
def test_sliding_window(window):
    arrays = _inputs(2, 128, 4, 2, 16, seed=1)
    o = _port(arrays, "f32", window)
    for ref in _reference(arrays, "f32", window):
        np.testing.assert_allclose(o, ref, atol=ATOL["f32"])


@pytest.mark.parametrize("B,S,H,K,D,window", [
    (1, 128, 4, 4, 32, None),  # the reference's bf16 case
    (2, 64, 8, 1, 8, None),
    (2, 128, 4, 2, 16, 48),
])
def test_bf16(B, S, H, K, D, window):
    arrays = _inputs(B, S, H, K, D, seed=2)
    o = _port(arrays, "bf16", window)
    for ref in _reference(arrays, "bf16", window):
        np.testing.assert_allclose(o, ref, atol=ATOL["bf16"])


@pytest.mark.parametrize("S,window", [(1, None), (7, None), (100, None), (100, 16)])
def test_ragged_s(S, window):
    arrays = _inputs(2, S, 4, 2, 16, seed=3)
    o = _port(arrays, "f32", window)
    (ref,) = _reference(arrays, "f32", window, kernel=False)
    np.testing.assert_allclose(o, ref, atol=ATOL["f32"])


def test_plain_version_is_flash_ref():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 33, 6, 3, 32, seed=4))
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=5),
                               flash_ref(q, k, v, window=5), rtol=0, atol=0)


def test_cpu_call_counts_plain_not_launches():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 8))
    ops.reset_counts()
    ops.flash_attention(q, k, v)
    assert (ops.counts["flash_attention"].launches, ops.counts["flash_attention"].plain_calls) == (0, 1)
    ops.reset_counts()
    assert ops.counts["flash_attention"].plain_calls == 0


def _bad(kind):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 4, 2, 16))
    if kind == "f64":
        q, k, v = q.double(), k.double(), v.double()
    elif kind == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif kind == "head_dim":
        q, k, v = q[..., :12].contiguous(), k[..., :12].contiguous(), v[..., :12].contiguous()
    elif kind == "groups":
        q = torch.zeros((1, 8, 3, 16))
    elif kind == "kv_shape":
        v = v[:, :4].contiguous()
    elif kind == "rank":
        q = q[0]
    elif kind == "last_dim_stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    return q, k, v


@pytest.mark.parametrize("kind,match", [
    ("f64", "float64"),
    ("mixed_dtype", "k is torch.bfloat16"),
    ("head_dim", "D = 12"),
    ("groups", "not a multiple"),
    ("kv_shape", r"k \(1, 8, 2, 16\) / v \(1, 4, 2, 16\)"),
    ("rank", "4-d"),
    ("last_dim_stride", "last dimension"),
])
def test_wrapper_rejects(kind, match):
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(*_bad(kind))


@pytest.mark.parametrize("window", [0, -3, 2.5])
def test_wrapper_rejects_bad_window(window):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=window)
