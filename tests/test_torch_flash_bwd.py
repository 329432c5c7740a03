"""The port's wgmma flash backward (``csrc/flash_attention_bwd_wgmma.cu``)
checked off the card, and the backward's routing.

A CUDA kernel cannot run here, so what the CPU can check of the two wgmma
backward kernels is their schedule and arithmetic: :func:`dq_emulation` and
:func:`dkdv_emulation` repeat them in numpy (tiles of the kernels' sizes,
only the tiles of the band, masks only on the tiles that cross the diagonal,
the window's lower edge or S, exp2 with log2(e) folded into the scale
against the forward's LSE in log2 units, padded rows at LSE = +inf, P and dS
rounded to the inputs' dtype as wgmma operands, zero-filled loads past S).
They are held against the port's plain version ``ref.flash_bwd_ref`` and the
reference's ``jax.vjp`` of ``repro.models.attention._full_attention`` on the
same inputs: float32 to ``BWD_TOL[f32]`` (1e-4 of the largest |plain|; the
emulation's f32 sums run in another order), bfloat16 to ``BWD_TOL[bf16]``
and ``BWD_ROW_REL`` per row (``ref.flash_bwd_errors``, as ``chip_smoke.py``
holds the kernels).  Against the reference's vjp, which runs in f32 on the
bf16-rounded inputs and has no o of its own, the bf16 emulation is given
the forward's o unrounded: the bf16 o's rounding in delta alone reads ~3e-2
per row at a window of 16 keys, and is the plain comparison's to carry.  The LSE the emulations take is the plain
``ref.flash_lse``, held against the forward kernel's own in
``test_torch_flash_attention.py``.  :func:`ops.bwd_route`, which picks the
kernel, is pure Python and tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    BWD_ROW_REL, BWD_TOL, flash_bwd_errors, flash_bwd_ref, flash_lse, flash_ref)

LOG2E = 1.4426950408889634
DQ_ROWS, DQ_KEYS = 128, 64  # bwd_dq: query rows an item, keys a K/V tile
KV_KEYS, KV_Q = 128, 64  # bwd_dkdv: keys an item, queries a step
WG = 64  # rows (dq) or keys (dkdv) of a consumer warpgroup
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _round_bf16(x):
    """float32 -> nearest-even bfloat16, returned in float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


ROUND = {"f32": lambda x: np.asarray(x, np.float32), "bf16": _round_bf16}


def _visible(q, k, window):
    on = k <= q
    return on & (q - k < window) if window else on


# ---- the kernels' bands -----------------------------------------------------


def dq_band(q0, S, window):
    """bwd_dq's item at q tile q0: the 64-key tiles it visits, and per
    warpgroup the visited tiles it masks (diagonal and window-edge tiles)."""
    j_begin = max(0, q0 - window + 1) // DQ_KEYS if window else 0
    tiles = list(range(j_begin, min(S - 1, q0 + DQ_ROWS - 1) // DQ_KEYS + 1))
    masked = []
    for cw in range(DQ_ROWS // WG):
        first = q0 + cw * WG
        last = first + WG - 1
        masked.append([j for j in tiles if j * DQ_KEYS + DQ_KEYS - 1 > first
                       or (window and j * DQ_KEYS <= last - window)])
    return tiles, masked


def dkdv_band(kv0, S, window):
    """bwd_dkdv's item at key tile kv0: the first query of each 64-query
    step it visits (for each query head), and per warpgroup the steps it
    masks (a query before a key, one beyond the window, or one past S)."""
    q_last = min(S - 1, kv0 + KV_KEYS - 1 + window - 1) if window else S - 1
    steps = list(range(kv0, (q_last // KV_Q) * KV_Q + 1, KV_Q))
    masked = []
    for cw in range(KV_KEYS // WG):
        first = kv0 + cw * WG
        last = first + WG - 1
        masked.append([q0 for q0 in steps if q0 < last
                       or (window and q0 + KV_Q - 1 - first >= window) or q0 + KV_Q > S])
    return steps, masked


# ---- the kernels' arithmetic --------------------------------------------------


def _prep(o, do, lse, S, pitch):
    """bwd_prep: delta = rowsum(dO o o) and the LSE in log2 units, (B, H,
    pitch), padded rows delta 0 and LSE +inf."""
    B, _, H, _ = o.shape
    delta = np.zeros((B, H, pitch), np.float32)
    delta[:, :, :S] = (do * o).sum(-1, dtype=np.float32).transpose(0, 2, 1)
    lse2 = np.full((B, H, pitch), np.inf, np.float32)
    lse2[:, :, :S] = lse * np.float32(LOG2E)
    return delta, lse2


def _padded(a, rows):
    """(B, S, heads, D) -> (B, heads, rows, D), zero-filled past S (TMA)."""
    out = np.zeros((a.shape[0], a.shape[2], rows, a.shape[3]), np.float32)
    out[:, :, :a.shape[1]] = a.transpose(0, 2, 1, 3)
    return out


def dq_emulation(q, k, v, o, do, lse, window=None, rnd=_round_bf16, band=dq_band):
    """numpy version of ``bwd_dq_wgmma`` on inputs already in the kernels'
    dtype (f32 arrays): dq (B, S, H, D) in f32 before the output rounding.
    ``band`` is the schedule (:func:`dq_band`)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    pitch = -(-S // 128) * 128
    delta, lse2 = _prep(o, do, lse, S, pitch)
    qp, dop = _padded(q, pitch), _padded(do, pitch)
    kp = np.repeat(_padded(k, pitch), G, axis=1)  # query head h reads kv head h // G
    vp = np.repeat(_padded(v, pitch), G, axis=1)
    c = np.float32(LOG2E / np.sqrt(D))
    dq = np.zeros((B, H, pitch, D), np.float32)
    for q0 in range(0, S, DQ_ROWS):
        tiles, masked = band(q0, S, window)
        for cw in range(DQ_ROWS // WG):
            r0 = q0 + cw * WG
            rows = np.arange(r0, r0 + WG)[:, None]
            Q, dO = qp[:, :, r0:r0 + WG], dop[:, :, r0:r0 + WG]
            l2, dl = lse2[:, :, r0:r0 + WG, None], delta[:, :, r0:r0 + WG, None]
            acc = np.zeros((B, H, WG, D), np.float32)
            for j in tiles:
                kv0 = j * DQ_KEYS
                Kt, Vt = kp[:, :, kv0:kv0 + DQ_KEYS], vp[:, :, kv0:kv0 + DQ_KEYS]
                s = Q @ Kt.transpose(0, 1, 3, 2)
                p = np.exp2(s * c - l2)
                if j in masked[cw]:
                    p = np.where(_visible(rows, np.arange(kv0, kv0 + DQ_KEYS)[None, :], window),
                                 p, np.float32(0))
                ds = p * (dO @ Vt.transpose(0, 1, 3, 2) - dl)
                acc += rnd(ds) @ Kt
            dq[:, :, r0:r0 + WG] = acc * np.float32(1 / np.sqrt(D))
    return dq.transpose(0, 2, 1, 3)[:, :S]


def dkdv_emulation(q, k, v, o, do, lse, window=None, rnd=_round_bf16):
    """numpy version of ``bwd_dkdv_wgmma`` on inputs already in the kernels'
    dtype (f32 arrays): (dk, dv) (B, S, K, D) in f32 before the output
    rounding."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    pitch = -(-S // 128) * 128
    delta, lse2 = _prep(o, do, lse, S, pitch)
    qp, dop = _padded(q, pitch), _padded(do, pitch)  # (B, H, pitch, D)
    kp, vp = _padded(k, pitch), _padded(v, pitch)  # (B, K, pitch, D)
    c = np.float32(LOG2E / np.sqrt(D))
    dk = np.zeros((B, K, pitch, D), np.float32)
    dv = np.zeros((B, K, pitch, D), np.float32)
    for kv0 in range(0, S, KV_KEYS):
        steps, masked = dkdv_band(kv0, S, window)
        for cw in range(KV_KEYS // WG):
            k0 = kv0 + cw * WG
            keys = np.arange(k0, k0 + WG)[:, None]
            Kt, Vt = kp[:, :, k0:k0 + WG], vp[:, :, k0:k0 + WG]  # (B, K, WG, D)
            acc_k = np.zeros((B, K, WG, D), np.float32)
            acc_v = np.zeros((B, K, WG, D), np.float32)
            for g in range(G):  # the query heads of each kv head in turn
                heads = np.arange(K) * G + g
                for q0 in steps:
                    Q = qp[:, heads, q0:q0 + KV_Q]
                    dO = dop[:, heads, q0:q0 + KV_Q]
                    l2 = lse2[:, heads, None, q0:q0 + KV_Q]
                    dl = delta[:, heads, None, q0:q0 + KV_Q]
                    pt = np.exp2((Kt @ Q.transpose(0, 1, 3, 2)) * c - l2)  # P^T (keys, queries)
                    if q0 in masked[cw]:
                        qs = np.arange(q0, q0 + KV_Q)[None, :]
                        pt = np.where(_visible(qs, keys, window) & (qs < S), pt, np.float32(0))
                    dst = pt * (Vt @ dO.transpose(0, 1, 3, 2) - dl)
                    acc_v += rnd(pt) @ dO
                    acc_k += rnd(dst) @ Q
            dk[:, :, k0:k0 + WG] = acc_k * np.float32(1 / np.sqrt(D))
            dv[:, :, k0:k0 + WG] = acc_v
    return dk.transpose(0, 2, 1, 3)[:, :S], dv.transpose(0, 2, 1, 3)[:, :S]


# ---- the emulations against the plain version and the reference ---------------


def _case(B, S, H, K, D, dtype_name, seed):
    """Unit-normal q, k, v, dO rounded to the dtype (f32 arrays)."""
    rng = np.random.default_rng(seed)
    rnd = ROUND[dtype_name]
    q, do = (rnd(rng.standard_normal((B, S, H, D)).astype(np.float32)) for _ in range(2))
    k, v = (rnd(rng.standard_normal((B, S, K, D)).astype(np.float32)) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("S,H,K,D,window", [
    (1, 4, 4, 64, None),  # G = 1
    (1, 4, 2, 64, None),  # G = 2
    (77, 4, 2, 64, None),
    (77, 4, 4, 64, 16),
    (300, 4, 2, 64, None),
    (300, 4, 4, 128, 48),
    (300, 4, 2, 64, 16),
    (300, 4, 2, 64, 48),
    (300, 4, 4, 80, None),  # zamba2-2.7b's head dim, G = 1
    (77, 4, 2, 80, 16),
])
def test_wgmma_bwd_emulation_matches_plain_and_reference(S, H, K, D, window, dtype_name):
    q, k, v, do = _case(2, S, H, K, D, dtype_name, seed=S + H * K + (window or 0))
    tdt = TORCH[dtype_name]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to = flash_ref(tq, tk, tv, window=window)
    lse = flash_lse(tq, tk, window=window).numpy()
    rnd = ROUND[dtype_name]

    def emulated(o):
        dq = dq_emulation(q, k, v, o, do, lse, window, rnd)
        dk, dv = dkdv_emulation(q, k, v, o, do, lse, window, rnd)
        return tuple(torch.from_numpy(rnd(x)) for x in (dq, dk, dv))

    want_plain = tuple(x.float() for x in flash_bwd_ref(tq, tk, tv, to, tdo, window=window))
    _, vjp = jax.vjp(lambda q, k, v: ref_attention._full_attention(q, k, v, window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_ref = tuple(torch.from_numpy(np.array(x, np.float32)) for x in vjp(jnp.asarray(do)))
    o_exact = flash_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=window).numpy()
    for got, want in ((emulated(to.float().numpy()), want_plain),
                      (emulated(o_exact), want_ref)):
        _, rel, row = flash_bwd_errors(got, want)
        assert rel <= BWD_TOL[tdt], rel
        assert dtype_name == "f32" or row <= BWD_ROW_REL, row


def test_wgmma_bwd_emulation_sees_a_dropped_tile():
    """The bf16 measure catches a schedule that skips one key tile: the
    emulation with dq's last tile of each item dropped reads far outside
    the tolerance that the true schedule meets."""
    q, k, v, do = _case(1, 256, 4, 2, 64, "bf16", seed=11)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    to = flash_ref(tq, tk, tv)
    lse = flash_lse(tq, tk).numpy()
    want = flash_bwd_ref(tq, tk, tv, to, tdo)
    o = to.float().numpy()
    dk, dv = dkdv_emulation(q, k, v, o, do, lse)

    def dropped(q0, S, window):
        tiles, masked = dq_band(q0, S, window)
        return tiles[:-1], masked

    for band, ok in ((dq_band, True), (dropped, False)):
        dq = dq_emulation(q, k, v, o, do, lse, band=band)
        got = tuple(torch.from_numpy(_round_bf16(x)) for x in (dq, dk, dv))
        _, rel, row = flash_bwd_errors(got, want)
        assert (row <= BWD_ROW_REL) == ok and (ok or row > 10 * BWD_ROW_REL), row


@pytest.mark.parametrize("S", [1, 77, 128, 300, 1000])
@pytest.mark.parametrize("window", [None, 1, 16, 48, 64, 128, 129, 300])
def test_wgmma_bwd_bands_visit_and_mask_only_what_they_must(S, window):
    """bwd_dq visits, per q tile, exactly the key tiles holding a visible
    (real row, real key) pair, and each warpgroup masks exactly the visited
    tiles holding an invisible pair among its 64 rows; bwd_dkdv visits, per
    key tile, exactly the query steps holding a visible pair, and each
    warpgroup masks exactly the steps holding a pair of its 64 keys that is
    invisible or whose query lies past S."""
    for q0 in range(0, S, DQ_ROWS):
        tiles, masked = dq_band(q0, S, window)
        real = np.arange(q0, min(S, q0 + DQ_ROWS))[:, None]
        want = [j for j in range(-(-S // DQ_KEYS))
                if _visible(real, np.arange(j * DQ_KEYS, min(S, j * DQ_KEYS + DQ_KEYS))[None, :],
                            window).any()]
        assert tiles == want, (q0, window)
        for cw in range(DQ_ROWS // WG):
            rows = np.arange(q0 + cw * WG, q0 + cw * WG + WG)[:, None]
            want_m = [j for j in tiles if not _visible(
                rows, np.arange(j * DQ_KEYS, j * DQ_KEYS + DQ_KEYS)[None, :], window).all()]
            assert masked[cw] == want_m, (q0, cw, window)
    for kv0 in range(0, S, KV_KEYS):
        steps, masked = dkdv_band(kv0, S, window)
        real = np.arange(kv0, min(S, kv0 + KV_KEYS))[:, None]
        want = [s0 for s0 in range(0, S, KV_Q)
                if _visible(np.arange(s0, min(S, s0 + KV_Q))[None, :], real, window).any()]
        assert steps == want, (kv0, window)
        for cw in range(KV_KEYS // WG):
            keys = np.arange(kv0 + cw * WG, kv0 + cw * WG + WG)[:, None]
            want_m = []
            for s0 in steps:
                qs = np.arange(s0, s0 + KV_Q)[None, :]
                if not (_visible(qs, keys, window) & (qs < S)).all():
                    want_m.append(s0)
            assert masked[cw] == want_m, (kv0, cw, window)


# ---- routing -------------------------------------------------------------------


def _view(shape, dtype, pad=0, offset=0):
    """(B, S, n, D) tensor as a view of rows D + pad wide, starting
    ``offset`` elements into its storage."""
    B, S, n, D = shape
    base = torch.zeros(B * S * n * (D + pad) + offset, dtype=dtype)
    return base[offset:].view(B, S, n, D + pad)[..., :D]


@pytest.mark.parametrize("dtype,D,layout,want", [
    (torch.float32, 128, "contiguous", "fma"),
    (torch.float32, 64, "contiguous", "fma"),
    (torch.float32, 16, "contiguous", "fma"),
    (torch.bfloat16, 16, "contiguous", "mma_sync"),
    (torch.bfloat16, 32, "contiguous", "mma_sync"),
    (torch.bfloat16, 64, "contiguous", "wgmma"),
    (torch.bfloat16, 128, "contiguous", "wgmma"),
    (torch.bfloat16, 128, "pad=2", "wgmma"),  # rows 260 B apart: copied first
    (torch.bfloat16, 64, "pad=2", "wgmma"),
    (torch.bfloat16, 16, "pad=2", "mma_sync"),
    (torch.bfloat16, 32, "pad=8", "mma_sync"),  # aligned, D outside wgmma's
    (torch.float32, 128, "pad=2", "fma"),
    (torch.bfloat16, 128, "pad=8", "wgmma"),  # rows 272 B apart
    (torch.bfloat16, 128, "offset=1", "wgmma"),  # base pointer 2 B off: copied
    (torch.bfloat16, 64, "heads-major", "wgmma"),  # (B, H, S, D) transposed
    (torch.bfloat16, 128, "k broadcast over B", "wgmma"),  # a 0 stride: copied
    (torch.bfloat16, 128, "B=S=1 odd strides", "wgmma"),  # size-1 dims' strides
    # zamba2-2.7b's head dim: every layout takes wgmma (unaligned ones copied)
    (torch.bfloat16, 80, "contiguous", "wgmma"),
    (torch.bfloat16, 80, "pad=2", "wgmma"),
    (torch.bfloat16, 80, "offset=1", "wgmma"),
])
def test_bwd_route(dtype, D, layout, want):
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
    assert ops.bwd_route(q, k, v) == want
    # the CPU runs the plain version whatever the route, without an LSE
    ops.reset_counts()
    o = ops.flash_attention(q, k, v)
    ops.flash_attention_bwd(q, k, v, o, torch.ones_like(o))
    assert (ops.counts["flash_attention_bwd"].launches,
            ops.counts["flash_attention_bwd"].plain_calls) == (0, 1)
    assert ops.bwd_route_launches == dict.fromkeys(ops.BWD_ROUTES, 0)


@pytest.mark.parametrize("route", ops.BWD_ROUTES)
def test_launch_bwd_refuses_cpu_tensors(route):
    """A named backward route launches its kernel or raises: a CPU tensor
    has none (its plain version is ``flash_attention_bwd``'s, not a route's);
    a missing LSE is refused on the card (``test_torch_cuda.py``)."""
    q, k, v = (torch.zeros((1, 8, n, 64), dtype=torch.bfloat16) for n in (4, 2, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.launch_bwd(route, q, k, v, q, q, torch.zeros((1, 4, 8)))


def test_flash_attention_function_saves_the_forward_lse():
    """Autograd on the CPU: the forward saves the plain LSE beside o, and
    the backward is the plain one."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, n, 16)).astype(np.float32))
               .requires_grad_(True) for n in (4, 2, 2))
    o = ops.flash_attention(q, k, v, window=6)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    assert torch.equal(saved[4], flash_lse(q.detach(), k.detach(), window=6))
