"""Port's flash-attention wrapper vs the reference Pallas kernel.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode and against the
reference's oracle ``flash_ref`` on the same numpy-made inputs: the shapes
of ``tests/test_flash_kernel.py`` (GQA, MHA, MQA), sliding windows
{16, 48, 128}, bfloat16 (f32 numpy inputs cast in both frameworks), and
ragged S (against ``flash_ref`` only: the reference kernel needs
S % block == 0).  Tolerances are those of ``tests/test_flash_kernel.py``:
atol 2e-5 in float32, 3e-2 in bfloat16 on unit-normal inputs.

The CUDA kernels themselves are held against the plain version on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py``.  What the CPU can
check of the wgmma kernel (``csrc/flash_attention_wgmma.cu``) is its
algorithm: :func:`wgmma_emulation` repeats it in numpy (128-row q tiles,
128-key KV tiles, q tiles last-first, only the KV tiles that meet the
band, masks only on the diagonal and window-edge tiles, exp2 with
log2(e) folded into the scale, p rounded to the inputs' dtype, zero-filled
loads past S) and is held against ``flash_ref`` and the reference kernel;
its LSE output, (m + log2 l) ln 2 from the log2-unit running max and sum, is
held against the plain LSE ``ref.flash_lse``, which is held against
``jax.nn.logsumexp`` of the reference's masked scores.  ``ops.route``, which
picks the kernel, is pure Python and tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import flash_ref as ref_flash_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import LSE_TOL, flash_lse, flash_ref

ATOL = {"f32": 2e-5, "bf16": 3e-2}
NEG_INF = np.float32(-1e30)
BQ = BK = 128  # the wgmma kernel's q and KV tiles
LOG2E = 1.4426950408889634
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


# ---- the wgmma kernel's algorithm, emulated in numpy ----------------------


def _round_bf16(x):
    """float32 -> nearest-even bfloat16, returned in float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


ROUND = {"f32": lambda x: np.asarray(x, np.float32), "bf16": _round_bf16}


def _band(q0, S, window):
    """KV tiles the kernel visits for the q tile at q0, and those it masks:
    the diagonal tile, and tiles that cross the window's lower edge."""
    j_begin = max(0, q0 - window + 1) // BK if window else 0
    tiles = list(range(j_begin, q0 // BK + 1))
    masked = [j for j in tiles
              if j * BK + BK - 1 > q0 or (window and j * BK <= q0 + BQ - 1 - window)]
    return tiles, masked


def wgmma_emulation(q, k, v, window=None, round_p=_round_bf16):
    """numpy version of ``flash_fwd_wgmma_kernel``'s arithmetic on inputs
    already in the kernel's dtype (f32 arrays).  Returns (o in f32 before
    the output rounding, {q tile: masked KV tiles}, the LSE (B, H, S) it
    writes)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    nq = -(-S // BQ)
    pad = ((0, 0), (0, nq * BQ - S), (0, 0), (0, 0))  # TMA zero-fills past S
    qp, kp, vp = (np.pad(np.asarray(a, np.float32), pad) for a in (q, k, v))
    # query head h reads KV head h // G
    kh = np.repeat(kp.transpose(0, 2, 1, 3), G, axis=1)  # (B, H, S', D)
    vh = np.repeat(vp.transpose(0, 2, 1, 3), G, axis=1)
    c = np.float32(LOG2E / np.sqrt(D))
    o = np.zeros((B, H, nq * BQ, D), np.float32)
    lse = np.zeros((B, H, nq * BQ), np.float32)
    masked_tiles = {}
    for qt in reversed(range(nq)):  # longest causal bands first
        q0 = qt * BQ
        rows = q0 + np.arange(BQ)
        Q = qp[:, q0:q0 + BQ].transpose(0, 2, 1, 3)  # (B, H, BQ, D)
        m = np.full((B, H, BQ), NEG_INF, np.float32)
        l = np.zeros((B, H, BQ), np.float32)
        acc = np.zeros((B, H, BQ, D), np.float32)
        tiles, masked = _band(q0, S, window)
        masked_tiles[qt] = masked
        for j in tiles:
            kv0 = j * BK
            s = Q @ kh[:, :, kv0:kv0 + BK].transpose(0, 1, 3, 2)  # (B, H, BQ, BK) f32
            if j in masked:
                cols = kv0 + np.arange(BK)
                on = cols[None, :] <= rows[:, None]
                if window:
                    on &= rows[:, None] - cols[None, :] < window
                t = np.where(on, s * c, NEG_INF)
                m_new = np.maximum(m, t.max(-1))
                p = np.where(on, np.exp2(t - m_new[..., None]), np.float32(0))
            else:
                m_new = np.maximum(m, s.max(-1) * c)
                p = np.exp2(s * c - m_new[..., None])
            alpha = np.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + round_p(p) @ vh[:, :, kv0:kv0 + BK]
            m = m_new
        l = np.maximum(l, np.float32(1e-30))
        o[:, :, q0:q0 + BQ] = acc / l[..., None]
        lse[:, :, q0:q0 + BQ] = (m + np.log2(l)) * np.float32(np.log(2.0))
    return o.transpose(0, 2, 1, 3)[:, :S], masked_tiles, lse[:, :, :S]


def _emulate(arrays, dtype_name, window=None):
    rnd = ROUND[dtype_name]
    o, _, _ = wgmma_emulation(*(rnd(a) for a in arrays), window=window, round_p=rnd)
    return rnd(o)


def _flash_ref_np(arrays, dtype_name, window=None):
    tdt = DTYPES[dtype_name][1]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    return flash_ref(q, k, v, window=window).float().numpy()


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,K,D", SHAPES + [(1, 384, 4, 2, 128), (2, 320, 4, 4, 80)])
def test_wgmma_emulation_matches_reference(B, S, H, K, D, dtype_name):
    arrays = _inputs(B, S, H, K, D, seed=5)
    o = _emulate(arrays, dtype_name)
    np.testing.assert_allclose(o, _flash_ref_np(arrays, dtype_name), atol=ATOL[dtype_name])
    for ref in _reference(arrays, dtype_name):
        np.testing.assert_allclose(o, ref, atol=ATOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("window", [16, 48, 128])
@pytest.mark.parametrize("B,S,H,K,D", [(2, 128, 4, 2, 16), (1, 512, 4, 2, 64)])
def test_wgmma_emulation_sliding_window(B, S, H, K, D, window, dtype_name):
    arrays = _inputs(B, S, H, K, D, seed=6)
    o = _emulate(arrays, dtype_name, window)
    np.testing.assert_allclose(o, _flash_ref_np(arrays, dtype_name, window),
                               atol=ATOL[dtype_name])
    for ref in _reference(arrays, dtype_name, window):
        np.testing.assert_allclose(o, ref, atol=ATOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("S,H,K,D,window", [
    (1, 16, 8, 128, None), (7, 16, 8, 128, None), (100, 16, 8, 128, None),
    (1000, 4, 2, 64, None), (1000, 4, 2, 128, 128), (333, 4, 4, 80, None),
])
def test_wgmma_emulation_ragged_s(S, H, K, D, window, dtype_name):
    arrays = _inputs(1, S, H, K, D, seed=7)
    o = _emulate(arrays, dtype_name, window)
    np.testing.assert_allclose(o, _flash_ref_np(arrays, dtype_name, window),
                               atol=ATOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("S,H,K,D,window", [
    (1, 4, 2, 64, None), (77, 4, 2, 64, 16), (300, 4, 4, 128, None), (300, 4, 2, 64, 48),
    (300, 4, 4, 80, None),
])
def test_wgmma_emulation_lse_matches_plain(S, H, K, D, window, dtype_name):
    """The forward kernel's LSE, (m + log2 l) ln 2 in f32, against the plain
    LSE on the same (dtype-rounded) inputs, to ``ref.LSE_TOL``."""
    rnd = ROUND[dtype_name]
    arrays = [rnd(a) for a in _inputs(2, S, H, K, D, seed=8)]
    _, _, lse = wgmma_emulation(*arrays, window=window, round_p=rnd)
    q, k = (torch.from_numpy(a) for a in arrays[:2])
    np.testing.assert_allclose(lse, flash_lse(q, k, window=window).numpy(), rtol=0,
                               atol=LSE_TOL)


@pytest.mark.parametrize("S,G,window", [(1, 1, None), (33, 2, None), (33, 2, 5), (64, 1, 16)])
def test_plain_lse_matches_jax_logsumexp(S, G, window):
    """``ref.flash_lse`` (natural log, (B, H, S)) against
    ``jax.nn.logsumexp`` over the reference's masked scores (its
    ``flash_ref``'s: scaled by 1/sqrt(D), -inf outside the causal band and
    the window), f32."""
    B, K, D = 2, 2, 16
    q, k, _ = _inputs(B, S, K * G, K, D, seed=9)
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = jnp.einsum("bqkgd,bskd->bkgqs", jnp.asarray(q).reshape(B, S, K, G, D),
                   jnp.asarray(k)) / jnp.sqrt(jnp.float32(D))
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1).reshape(B, K * G, S)
    got = flash_lse(torch.from_numpy(q), torch.from_numpy(k), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, K * G, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_cpu_forward_with_lse_is_the_plain_pair():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 20, 4, 2, 16, seed=10))
    o, lse = ops._forward(q, k, v, 7, lse=True)
    assert torch.equal(o, flash_ref(q, k, v, window=7))
    assert torch.equal(lse, flash_lse(q, k, window=7))


@pytest.mark.parametrize("window", [None, 1, 16, 48, 128, 129, 300])
def test_wgmma_band_visits_and_masks_only_what_it_must(window):
    """Per q tile, the kernel visits exactly the KV tiles holding a visible
    (row, key) pair and masks exactly those holding an invisible one among
    them (all 128 rows of the tile, ragged ones included)."""
    S = 1000
    for q0 in range(0, S, BQ):
        rows = np.arange(q0, q0 + BQ)[:, None]
        tiles, masked = _band(q0, S, window)
        want_tiles, want_masked = [], []
        for j in range(-(-S // BK)):
            cols = np.arange(j * BK, j * BK + BK)[None, :]
            on = (cols <= rows) & ((rows - cols < window) if window else True)
            if on.any():
                want_tiles.append(j)
                if not on.all():
                    want_masked.append(j)
        assert tiles == want_tiles and masked == want_masked, (q0, window)


def _view(shape, dtype, pad=0, offset=0):
    """(B, S, n, D) tensor as a view of rows D + pad wide, starting
    ``offset`` elements into its storage."""
    B, S, n, D = shape
    base = torch.zeros(B * S * n * (D + pad) + offset, dtype=dtype)
    return base[offset:].view(B, S, n, D + pad)[..., :D]


@pytest.mark.parametrize("dtype,D,layout,want", [
    (torch.float32, 128, "contiguous", "fma"),
    (torch.float32, 64, "contiguous", "fma"),
    (torch.float32, 8, "contiguous", "fma"),
    (torch.bfloat16, 8, "contiguous", "fma"),
    (torch.bfloat16, 16, "contiguous", "mma_sync"),
    (torch.bfloat16, 32, "contiguous", "mma_sync"),
    (torch.bfloat16, 64, "contiguous", "wgmma"),
    (torch.bfloat16, 128, "contiguous", "wgmma"),
    (torch.bfloat16, 128, "pad=2", "mma_sync"),  # rows 260 B apart
    (torch.bfloat16, 64, "pad=2", "mma_sync"),
    (torch.bfloat16, 16, "pad=2", "mma_sync"),
    (torch.float32, 128, "pad=2", "fma"),
    (torch.bfloat16, 128, "pad=8", "wgmma"),  # rows 272 B apart
    (torch.bfloat16, 128, "offset=1", "mma_sync"),  # base pointer 2 B off
    (torch.bfloat16, 64, "heads-major", "wgmma"),  # (B, H, S, D) transposed
    (torch.bfloat16, 128, "k broadcast over B", "mma_sync"),  # a 0 stride
    (torch.bfloat16, 128, "B=S=1 odd strides", "wgmma"),  # size-1 dims' strides
    # zamba2-2.7b's head dim: rows of 160 B, 164 B (off 16 bytes), 176 B
    (torch.bfloat16, 80, "contiguous", "wgmma"),
    (torch.bfloat16, 80, "pad=2", "mma_sync"),
    (torch.bfloat16, 80, "pad=8", "wgmma"),
    (torch.bfloat16, 80, "heads-major", "wgmma"),
])
def test_route(dtype, D, layout, want):
    B, S, H, K = 2, 16, 4, 2
    if layout == "contiguous":
        q, k, v = (torch.zeros((B, S, n, D), dtype=dtype) for n in (H, K, K))
    elif layout.startswith("pad="):
        pad = int(layout[4:])
        q, k, v = (_view((B, S, n, D), dtype, pad=pad) for n in (H, K, K))
    elif layout == "offset=1":
        q = _view((B, S, H, D), dtype, offset=1)
        k, v = (torch.zeros((B, S, K, D), dtype=dtype) for _ in range(2))
    elif layout == "heads-major":
        q, k, v = (torch.zeros((B, n, S, D), dtype=dtype).transpose(1, 2) for n in (H, K, K))
    elif layout == "k broadcast over B":
        q, v = torch.zeros((B, S, H, D), dtype=dtype), torch.zeros((B, S, K, D), dtype=dtype)
        k = torch.zeros((1, S, K, D), dtype=dtype).expand(B, S, K, D)
    else:  # B = S = 1 with odd strides, never stepped over
        q, k, v = (torch.zeros(n * D, dtype=dtype).as_strided((1, 1, n, D), (7, 3, D, 1))
                   for n in (H, K, K))
    assert ops.route(q, k, v) == want
    # the CPU runs the plain version whatever the route
    ops.reset_counts()
    ops.flash_attention(q, k, v)
    assert ops.counts["flash_attention"].plain_calls == 1
    assert ops.route_launches == dict.fromkeys(ops.ROUTES, 0)


def test_launch_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 8, 4, 2, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.launch("wgmma", q, k, v)


def test_build_hash_covers_every_csrc_file(tmp_path):
    """An edited header under csrc/ names a new library (so it is rebuilt),
    as an edited source does; an unchanged tree loads the built one."""
    import shutil

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    out = tmp_path / "_build"
    first = nvcc._digest(csrc, build.SOURCES)
    (out / f"libflash_attention-{first}.so").parent.mkdir()
    (out / f"libflash_attention-{first}.so").write_bytes(b"")
    path, seconds, _ = nvcc.build(csrc, build.SOURCES, out, "flash_attention")
    assert path.name == f"libflash_attention-{first}.so" and seconds == 0.0  # no nvcc run
    for name in ("flash_common.cuh", "flash_attention_wgmma.cu"):
        f = csrc / name
        f.write_text(f.read_text() + "\n// edited\n")
        digest = nvcc._digest(csrc, build.SOURCES)
        assert digest != first, name
        first = digest


_RES_USAGE = """Resource usage:
 Function _ZN5flash4sm9022flash_fwd_wgmma_kernelILi128ELb0EEEv4Args:
  REG:168 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:976 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN5flash4sm9022flash_fwd_wgmma_kernelILi128ELb1EEEv4Args:
  REG:170 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:984 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
_SASS = """	code for sm_90a
		Function : _ZN5flash4sm9022flash_fwd_wgmma_kernelILi128ELb0EEEv4Args
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                                       /* 0x000fe20000000800 */
        /*0010*/              @!P0 BRA 0x200 ;                         /* 0x0000000000007947 */
        /*0020*/                   EXIT ;                              /* 0x000000000000794d */
		Function : _ZN5flash4sm9022flash_fwd_wgmma_kernelILi128ELb1EEEv4Args
        /*0000*/                   EXIT ;                              /* 0x000000000000794d */
		Function : _Z10bwd_prep_kv
        /*0000*/                   EXIT ;                              /* 0x000000000000794d */
"""


def test_compare_sass_pairs_kernels_across_builds(monkeypatch, capsys):
    """``compare.py --sass`` pairs kernels by head dim and LSE flag (an
    earlier build's ``<D>`` instantiation as the no-LSE one) and counts the
    SASS lines that differ, in full and in opcodes alone."""
    from repro_torch.kernels.flash_attention import compare

    def cuobjdump(flag, path):
        text = _RES_USAGE if flag == "-res-usage" else _SASS
        if path == "earlier":  # one template parameter, a branch target moved
            text = text.replace("ILi128ELb0EE", "ILi128EE").replace("0x200", "0x210")
        return text

    monkeypatch.setattr(compare, "_cuobjdump", cuobjdump)
    code = compare._sass("this", "flash_fwd_wgmma")
    assert sorted(code) == [("128", "Lb0"), ("128", "Lb1")]
    assert code["128", "Lb0"] == ("REG:168 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:976 TEXTURE:0 "
                                  "SURFACE:0 SAMPLER:0",
                                  ["LDC R1, c[0x0][0x28]", "@!P0 BRA 0x200", "EXIT"])
    assert compare._compare_sass({"this": "this", "earlier": "earlier"}, "flash_fwd_wgmma") == 0
    out = capsys.readouterr().out
    assert ("[sass] D=128 Lb0 earlier: 3 instructions; REG:168 STACK:0 SHARED:0 LOCAL:0 "
            "CONSTANT[0]:976 TEXTURE:0 SURFACE:0 SAMPLER:0; lines differing from this: 2 in "
            "full, 0 in opcodes") in out
    assert "[sass]   +@!P0 BRA 0x210" in out
    assert "[sass] D=128 Lb1 earlier: 1 instructions" in out
    assert compare._compare_sass({"this": "this"}, "no_such_kernel") == 1
