"""The port's CUDA kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip without a card.  This
file imports neither jax nor the reference package, so on the card it
runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params
from repro_torch.core.basis import basis_tables
from repro_torch.core.operators import ASSEMBLY_LEVELS, ElasticityOperator
from repro_torch.distributed.sharding import gather_scenario, tree_to
from repro_torch.fem.space import H1Space
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    BWD_ROW_REL, BWD_TOL, LSE_TOL, flash_bwd_errors, flash_bwd_ref, flash_lse, flash_ref)
from repro_torch.kernels.pa_elasticity import build, ops
from repro_torch.kernels.pa_elasticity.ref import paop_ref
from repro_torch.launch.solve import solve_beam
from repro_torch.fem.mesh import beam_hex
from repro_torch.models import moe
from repro_torch.models.transformer import init_params
from repro_torch.obs.throughput import operator_throughput
from repro_torch.profiling import device_time_by_category
from repro_torch.serve import elasticity_service
from repro_torch.serve.elasticity_service import ElasticityService, SolveRequest
from repro_torch.serve.recovery import ServiceRecovery
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.solvers.batched import BatchedGMGSolver
from repro_torch.solvers.gmg import hierarchy_spaces

TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-4, 2e-5)}  # rtol, atol / max|ref|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _args(p, ne, dtype, device):
    tb = basis_tables(p)
    g = torch.Generator().manual_seed(p)
    d, q = tb.d1d, tb.q1d
    jinv = torch.eye(3, dtype=dtype) + 0.1 * torch.randn((3, 3), generator=g, dtype=dtype)
    args = [
        torch.randn((ne, 3, d, d, d), generator=g, dtype=dtype),
        torch.rand((ne, q, q, q), generator=g, dtype=dtype) + 0.5,
        torch.rand((ne, q, q, q), generator=g, dtype=dtype) + 0.5,
        jinv,
        torch.as_tensor(tb.B, dtype=dtype),
        torch.as_tensor(tb.G, dtype=dtype),
    ]
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", ops.SUPPORTED_P)
def test_kernel_matches_plain_on_card(card, p, dtype):
    rtol, atol = TOL[dtype]
    # a block holds `elems` whole elements: 41 elems + 1 leaves the last
    # block ragged (where elems > 1)
    elems = build.load().config("pa_elasticity", dtype, p + 1)["elems"]
    for ne in (1, 7, 300, 41 * elems + 1):
        args = _args(p, ne, dtype, card)
        before = ops.counts["pa_elasticity"].launches
        y = ops.pa_elasticity(*args)
        assert ops.counts["pa_elasticity"].launches == before + 1
        ref = paop_ref(*args)
        torch.testing.assert_close(y, ref, rtol=rtol, atol=atol * float(ref.abs().max()))


def _bf16_args(p, ne, device, offset):
    """bfloat16 x_e, lam_w and mu_w as views at a storage offset of
    ``offset`` values (2-byte but not 16-byte aligned for 1 and 3), and
    float32 tables, as the bfloat16 kernel takes them."""
    x, lam, mu, jinv, B, G = _args(p, ne, torch.float32, "cpu")

    def at_offset(t):
        buf = torch.zeros(t.numel() + offset, dtype=torch.bfloat16, device=device)
        view = buf[offset:].view(t.shape)
        view.copy_(t.to(torch.bfloat16))
        return view

    return [at_offset(x), at_offset(lam), at_offset(mu)] + [t.to(device) for t in (jinv, B, G)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("p", ops.SUPPORTED_P)
def test_bf16_kernel_matches_plain_on_card(card, p, offset):
    """The bfloat16 instantiation against its plain version (f32 apply on
    the same bfloat16 inputs, y rounded once): the two sum in other orders,
    so a value may round to the neighbouring bfloat16, within 2^-7 of max
    |y|."""
    elems = build.load().config("pa_elasticity", torch.bfloat16, p + 1)["elems"]
    for ne in (1, 7, 300, 41 * elems + 1):
        args = _bf16_args(p, ne, card, offset)
        before = ops.counts["pa_elasticity"].launches
        y = ops.pa_elasticity(*args)
        assert ops.counts["pa_elasticity"].launches == before + 1
        assert y.dtype == torch.bfloat16
        ref = paop_ref(*args).float()
        assert float((y.float() - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_bf16_solves_on_card_match_cpu(card):
    """solve_beam and a batched solve (p=2, refine=1) under mixed-bf16 on
    the card and on the CPU from the same start vectors: the kernel and its
    plain version round a few values of y apart, so iterations within 1
    and x within 1e-5 of max |x|; the card launches PAop in bfloat16 and
    makes no plain call."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    g = torch.Generator().manual_seed(0)
    sv = [torch.randn((sp.nscalar, 3), generator=g, dtype=torch.float64) for sp in spaces[1:]]
    ops.reset_counts()
    a = solve_beam(2, 1, precision="mixed-bf16", device=card, start_vectors=sv,
                   keep_solution=True)
    assert ops.counts["pa_elasticity"].plain_calls == 0
    assert ops.counts["pa_elasticity"].launches > 0
    b = solve_beam(2, 1, precision="mixed-bf16", device="cpu", start_vectors=sv,
                   keep_solution=True)
    assert a.converged and b.converged and abs(a.iterations - b.iterations) <= 1
    scale = float(b.x.abs().max())
    torch.testing.assert_close(a.x.cpu(), b.x, rtol=0, atol=1e-5 * scale)
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 5.0), 2: (2.0, 2.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2]])
    out = [BatchedGMGSolver(beam_hex(), 1, 2, precision="mixed-bf16", device=dev,
                            start_vectors=sv).solve(mats, trs, 1e-6)
           for dev in (card, "cpu")]
    assert all(bool(r.converged.all()) for r in out)
    assert bool(((out[0].iterations.cpu() - out[1].iterations).abs() <= 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4, 8])
def test_baseline_matches_plain_on_card(card, p):
    rtol, atol = TOL[torch.float64]
    for ne in (1, 7, 300):
        args = _args(p, ne, torch.float64, card)
        before = ops.counts["pa_elasticity"].launches
        y = ops.launch_baseline(*args)
        assert ops.counts["pa_elasticity"].launches == before  # not counted
        ref = paop_ref(*args)
        torch.testing.assert_close(y, ref, rtol=rtol, atol=atol * float(ref.abs().max()))


@pytest.mark.cuda
def test_probe_on_card(card):
    ops.check_probe(card)
    # a tensor on the current card takes the path without a device context
    x = torch.randn(1000, device=card)
    assert x.device.index == torch.cuda.current_device()
    before = ops.counts["probe"].launches
    assert torch.equal(ops.probe(x), 2 * x)
    assert ops.counts["probe"].launches == before + 1


@pytest.mark.cuda
def test_small_solve_on_card_matches_cpu(card):
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    g = torch.Generator().manual_seed(0)
    sv = [torch.randn((sp.nscalar, 3), generator=g, dtype=torch.float64) for sp in spaces[1:]]
    ops.reset_counts()
    a = solve_beam(2, 1, device=card, start_vectors=sv, keep_solution=True)
    assert ops.counts["pa_elasticity"].plain_calls == 0
    assert ops.counts["pa_elasticity"].launches > 0
    b = solve_beam(2, 1, device="cpu", start_vectors=sv, keep_solution=True)
    assert a.iterations == b.iterations and a.converged
    scale = float(b.x.abs().max())
    torch.testing.assert_close(a.x.cpu(), b.x, rtol=1e-10, atol=1e-10 * scale)
    # the deterministic scatter makes a repeat on the card bitwise equal
    c = solve_beam(2, 1, device=card, start_vectors=sv, keep_solution=True)
    assert torch.equal(a.x, c.x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_kernel_on_scenario_folded_batch(card, p, dtype):
    """S scenarios folded into the element axis, each with its own lam_w /
    mu_w, S * NE ragged against the block size: the launch agrees with the
    plain version, and each scenario's slice equals that scenario's own
    launch bitwise (elements are independent)."""
    rtol, atol = TOL[dtype]
    elems = build.load().config("pa_elasticity", dtype, p + 1)["elems"]
    s, ne = 3, 7 * elems + 1
    x, lam, mu, jinv, B, G = _args(p, s * ne, dtype, card)
    scale = torch.tensor([1.0, 50.0, 0.02], dtype=dtype, device=card)
    lam = (lam.reshape(s, ne, -1) * scale[:, None, None]).reshape(lam.shape)
    mu = (mu.reshape(s, ne, -1) * scale[:, None, None]).reshape(mu.shape)
    before = ops.counts["pa_elasticity"].launches
    y = ops.pa_elasticity(x, lam, mu, jinv, B, G)
    assert ops.counts["pa_elasticity"].launches == before + 1
    ref = paop_ref(x, lam, mu, jinv, B, G)
    for i in range(s):
        rows = slice(i * ne, (i + 1) * ne)
        torch.testing.assert_close(
            y[rows], ref[rows], rtol=rtol, atol=atol * float(ref[rows].abs().max())
        )
        one = ops.pa_elasticity(x[rows].contiguous(), lam[rows].contiguous(),
                                mu[rows].contiguous(), jinv, B, G)
        assert torch.equal(one, y[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed", "f32"])
def test_small_batched_solve_on_card_matches_cpu(card, precision):
    """p=2, refine=1, S=3 batched solve (dict, field, dict; tolerances 1e-6,
    1e-8 and 1e-10, or 1e-13 under f32, below its floor) on the card and on
    the CPU from the same start vectors."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    g = torch.Generator().manual_seed(0)
    sv = [torch.randn((sp.nscalar, 3), generator=g, dtype=torch.float64) for sp in spaces[1:]]
    rng = np.random.default_rng(0)
    ne = spaces[-1].nelem
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)},
            (rng.lognormal(0, 0.5, ne), rng.lognormal(0, 0.5, ne)),
            {1: (10.0, 5.0), 2: (2.0, 2.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2], [0.0, 0.0, -5e-3]])
    tols = [1e-6, 1e-8, 1e-13 if precision == "f32" else 1e-10]
    out = {}
    for dev in (card, torch.device("cpu")):
        solver = BatchedGMGSolver(beam_hex(), 1, 2, precision=precision, device=dev,
                                  start_vectors=sv)
        ops.reset_counts()
        out[dev is card] = solver.solve(mats, trs, tols)
        c = ops.counts["pa_elasticity"]
        if dev.type == "cuda":
            assert c.launches > 0 and c.plain_calls == 0
    a, b = out[True], out[False]
    assert bool(a.converged.all()) and bool(b.converged.all())
    assert torch.equal(a.fallback.cpu(), b.fallback)
    assert bool(b.fallback[2]) == (precision == "f32")
    if precision == "f64":
        assert torch.equal(a.iterations.cpu(), b.iterations)
    rtol = {"f64": 1e-10, "mixed": 1e-6, "f32": 1e-4}[precision]
    scale = float(b.x.abs().max())
    torch.testing.assert_close(a.x.cpu(), b.x, rtol=rtol, atol=rtol * scale)


@pytest.mark.cuda
def test_batched_chunks_and_refill_are_bitwise_on_card(card):
    solver = BatchedGMGSolver(beam_hex(), 1, 2, device=card)
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 5.0), 2: (2.0, 2.0)},
            {1: (20.0, 20.0), 2: (3.0, 1.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2], [0.0, 0.0, -5e-3]])
    lam, mu = solver.pack_materials(mats)
    ones = np.ones(3, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(3))
    whole, _ = solver.run_chunk(trs, 1e-10, ones, solver.empty_state(3), prep, 1000,
                                do_reset=True)
    state, _ = solver.run_chunk(trs, 1e-10, ones, solver.empty_state(3), prep, 3,
                                do_reset=True)
    after3 = state
    while bool(state.active.any()):
        state, _ = solver.run_chunk(trs, 1e-10, ~ones, state, prep, 3)
    assert torch.equal(state.x, whole.x) and torch.equal(state.iters, whole.iters)
    mask = np.array([False, True, False])
    lam2, mu2 = solver.pack_materials([mats[0], {1: (9.0, 9.0), 2: (1.0, 3.0)}, mats[2]])
    prep2 = solver.prepare(lam2, mu2, mask, prep)
    refilled, _ = solver.run_chunk(trs, 1e-10, mask, after3, prep2, 4, do_reset=True)
    untouched, _ = solver.run_chunk(trs, 1e-10, ~ones, after3, prep, 4)
    for name in ("x", "r", "d", "nom", "iters", "active"):
        a, b = getattr(refilled, name), getattr(untouched, name)
        assert torch.equal(a[[0, 2]], b[[0, 2]]), name


FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # tests/test_flash_kernel.py


def _flash_route(dtype, D, pad):
    """The kernel ops.route must pick: bf16 at D in {64, 80, 128} with
    16-byte rows (pad 0 or 8) takes wgmma, other bf16 at D >= 16 mma_sync,
    the rest fma."""
    if dtype == torch.bfloat16 and D in (64, 80, 128) and pad in (0, 8):
        return "wgmma"
    return "mma_sync" if dtype == torch.bfloat16 and D >= 16 else "fma"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,D,window", [
    (2, 128, 4, 2, 16, None),
    (1, 256, 8, 8, 32, None),  # MHA
    (2, 64, 8, 1, 8, None),  # MQA
    (1, 512, 4, 2, 64, None),
    (2, 128, 4, 2, 16, 48),
    (1, 1, 4, 2, 128, None),  # ragged S
    (1, 100, 6, 3, 128, 16),
    (2, 300, 16, 8, 128, None),
    # the wgmma route (bf16, pad 0) at D = 64 and 128: S in {1, 100, 300,
    # 2048}, a window of 128, MHA and MQA
    (1, 1, 8, 4, 64, None),
    (2, 100, 8, 4, 64, None),
    (1, 300, 4, 2, 64, 128),
    (1, 2048, 4, 2, 64, None),
    (2, 100, 16, 8, 128, None),
    (1, 300, 8, 2, 128, 128),
    (1, 2048, 4, 2, 128, None),
    (1, 300, 8, 8, 128, None),  # MHA
    (2, 300, 8, 1, 128, None),  # MQA
    # query groups of 7 (qwen2-vl-7b, 28 / 4) and 8 (qwen3-32b, 64 / 8)
    (2, 300, 28, 4, 128, None),
    (1, 1000, 28, 4, 128, 128),
    (2, 300, 64, 8, 128, None),
    (1, 77, 64, 8, 128, None),
])
@pytest.mark.parametrize("pad", [0, 2])  # 2: row strides no multiple of 8
def test_flash_kernel_matches_plain_on_card(card, B, S, H, K, D, window, dtype, pad):
    g = torch.Generator(device=card).manual_seed(S)
    q = torch.randn((B, S, H, D + pad), generator=g, device=card).to(dtype)[..., :D]
    k = torch.randn((B, S, K, D + pad), generator=g, device=card).to(dtype)[..., :D]
    v = torch.randn((B, S, K, D + pad), generator=g, device=card).to(dtype)[..., :D]
    want = _flash_route(dtype, D, pad)
    assert flash_ops.route(q, k, v) == want
    before = flash_ops.counts["flash_attention"].launches
    routes = dict(flash_ops.route_launches)
    o = flash_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_ops.counts["flash_attention"].launches == before + 1
    routes[want] += 1
    assert flash_ops.route_launches == routes
    assert o.dtype == dtype and o.shape == q.shape
    ref = flash_ref(q, k, v, window=window)
    torch.testing.assert_close(o.float(), ref.float(), rtol=0, atol=FLASH_ATOL[dtype])
    if dtype == torch.bfloat16:
        # also row by row, scaled to the row: ||o - ref|| / ||ref|| per (b, s, h)
        diff = (o.float() - ref.float()).norm(dim=-1)
        assert float((diff / ref.float().norm(dim=-1)).max()) <= 1e-2


def _bwd_inputs(card, B, S, H, K, D, dtype, pad=0, seed=0):
    """q, k, v, dO on the card (views of rows D + pad wide), and the forward
    kernel's o and LSE on them."""
    g = torch.Generator(device=card).manual_seed(seed)
    q, do = (torch.randn((B, S, H, D + pad), generator=g, device=card).to(dtype)[..., :D]
             for _ in range(2))
    k, v = (torch.randn((B, S, K, D + pad), generator=g, device=card).to(dtype)[..., :D]
            for _ in range(2))
    return q, k, v, do


def _check_bwd(q, k, v, do, window, want_route):
    """The backward route ``want_route`` on these inputs against its plain
    version (``ref.flash_bwd_errors``: f32 to 1e-4 of max |plain|; bf16 to
    2e-2 of max |plain| and 2e-2 per row), bitwise repeated, counted once on
    its route; the forward's o and LSE first held against theirs."""
    dtype = q.dtype
    assert flash_ops.bwd_route(q, k, v) == want_route
    o, lse = flash_ops.launch(flash_ops.route(q, k, v), q, k, v, window=window, lse=True)
    torch.cuda.synchronize()
    assert float((lse - flash_lse(q, k, window=window)).abs().max()) <= LSE_TOL
    before = flash_ops.counts["flash_attention_bwd"].launches
    plain = flash_ops.counts["flash_attention_bwd"].plain_calls
    routes = dict(flash_ops.bwd_route_launches)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
    torch.cuda.synchronize()
    assert flash_ops.counts["flash_attention_bwd"].launches == before + 1
    routes[want_route] += 1
    assert flash_ops.bwd_route_launches == routes
    want = flash_bwd_ref(q, k, v, o, do, window=window)
    for x, like in zip(got, (q, k, v)):
        assert x.dtype == dtype and x.shape == like.shape
    _, err, row = flash_bwd_errors(got, want)
    assert err <= BWD_TOL[dtype]
    assert dtype == torch.float32 or row <= BWD_ROW_REL
    again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flash_ops.counts["flash_attention_bwd"].plain_calls == plain
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,D,window,pad", [
    (2, 1, 4, 2, 64, None, 0),
    (2, 77, 4, 2, 16, None, 0),
    (1, 300, 4, 4, 64, None, 0),
    (2, 130, 4, 2, 128, 48, 0),
    (1, 1024, 16, 8, 128, None, 0),
    (1, 200, 2, 1, 32, 64, 0),
    (2, 100, 8, 4, 64, None, 2),  # views of wider rows: copied before the kernel
])
def test_flash_bwd_kernel_matches_plain_on_card(card, B, S, H, K, D, window, pad, dtype):
    """Each backward route against its plain version (``_check_bwd``): f32
    on fma; bf16 on wgmma where D in {64, 80, 128} (unaligned views copied
    first), else on mma_sync (D in {16, 32}); and autograd through
    flash_attention on the card runs the same kernels once."""
    q, k, v, do = _bwd_inputs(card, B, S, H, K, D, dtype, pad, seed=S + D)
    want = ("fma" if dtype == torch.float32 else
            "wgmma" if D in (64, 80, 128) else "mma_sync")
    got = _check_bwd(q, k, v, do, window, want)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(flash_ops.flash_attention(*leaves, window=window), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,H,K,window", [
    (2, 1, 4, 2, None), (2, 77, 4, 2, None), (1, 300, 4, 2, None),  # ragged S, G = 2
    (2, 77, 4, 4, 16), (1, 300, 4, 4, 48), (1, 300, 4, 2, 16),  # windows, G = 1 and 2
    (1, 1024, 16, 8, None),
    (2, 77, 28, 4, None), (1, 300, 28, 4, 48),  # G = 7 (qwen2-vl-7b)
    (1, 300, 64, 8, None), (2, 77, 64, 8, 16),  # G = 8 (qwen3-32b)
])
def test_flash_bwd_wgmma_matches_plain_on_card(card, B, S, H, K, D, window):
    """The wgmma backward route against its plain version, bitwise repeated,
    at ragged S, G in {1, 2, 7, 8}, windows {16, 48} and (1, 1024, 16, 8, D)."""
    _check_bwd(*_bwd_inputs(card, B, S, H, K, D, torch.bfloat16, seed=S * D + H), window,
               "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("pad", [0, 2, 8])  # 2: rows off 16 bytes; 8: aligned, still D < 64
def test_flash_bwd_mma_sync_small_d_on_card(card, D, pad):
    """The mma_sync backward route keeps D in {16, 32}, aligned or not."""
    _check_bwd(*_bwd_inputs(card, 2, 150, 4, 2, D, torch.bfloat16, pad, seed=D), 48, "mma_sync")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 2])  # 2: views copied before either route
def test_flash_bwd_mma_sync_on_wgmma_inputs(card, pad):
    """launch_bwd names the mma_sync route on inputs the wgmma route takes
    (the timing comparison's path): both within tolerance of the plain
    version."""
    q, k, v, do = _bwd_inputs(card, 1, 300, 8, 4, 128, torch.bfloat16, pad, seed=7)
    o, lse = flash_ops.launch(flash_ops.route(q, k, v), q, k, v, lse=True)
    want = flash_bwd_ref(q, k, v, o, do)
    for name in flash_ops.BWD_ROUTES[:2]:
        got = flash_ops.launch_bwd(name, q, k, v, o, do, lse)
        _, err, row = flash_bwd_errors(got, want)
        assert err <= BWD_TOL[torch.bfloat16] and row <= BWD_ROW_REL, name


# zamba2-2.7b's head dim, 80 (2560 / 32): bf16 only, on the wgmma routes
# (the forward of unaligned rows on mma_sync)
D80_CASES = [
    (2, 1, 4, 2, None), (2, 77, 4, 2, None), (1, 300, 8, 8, None),  # ragged S, G = 2, MHA
    (2, 130, 4, 2, 48), (1, 300, 8, 1, 16),  # windows, MQA
    (1, 1024, 32, 32, None), (2, 333, 32, 32, None),  # zamba2's (H, K), a ragged S
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,window", D80_CASES)
@pytest.mark.parametrize("pad", [0, 2, 8])  # 2: rows off 16 bytes; 8: aligned views
def test_flash_kernel_d80_matches_plain_on_card(card, B, S, H, K, window, pad):
    """bf16 at D = 80 takes the wgmma forward on 16-byte rows (pad 0 and 8)
    and the mma_sync forward on unaligned ones (pad 2), within the bf16
    tolerances of ``test_flash_kernel_matches_plain_on_card``."""
    test_flash_kernel_matches_plain_on_card(card, B, S, H, K, 80, window, torch.bfloat16, pad)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,window", D80_CASES)
@pytest.mark.parametrize("pad", [0, 2])  # 2: views copied before the kernel
def test_flash_bwd_d80_matches_plain_on_card(card, B, S, H, K, window, pad):
    """bf16 at D = 80 takes the wgmma backward, aligned or not (unaligned
    views copied first; ``_check_bwd``: the forward's LSE first, bitwise
    repeated), and autograd through flash_attention runs the same kernels."""
    q, k, v, do = _bwd_inputs(card, B, S, H, K, 80, torch.bfloat16, pad, seed=S + H)
    got = _check_bwd(q, k, v, do, window, "wgmma")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(flash_ops.flash_attention(*leaves, window=window), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


@pytest.mark.cuda
def test_flash_d80_one_tile_layout_on_card(card):
    """One 128-row tile at D = 80 (B = H = K = 1), v's column d one where
    key t has t % 80 == d: each output column sums the probabilities of its
    own keys, so a column of the 16-column box read out of order, or one
    box's columns put in the other's place, shows at once.  Forward (wgmma,
    its LSE) and backward against their plain versions."""
    g = torch.Generator(device=card).manual_seed(80)
    q, k, do = (torch.randn((1, 128, 1, 80), generator=g, device=card).to(torch.bfloat16)
                for _ in range(3))
    t = torch.arange(128, device=card)
    v = (t[:, None] % 80 == torch.arange(80, device=card)[None]).to(torch.bfloat16)
    v = v.reshape(1, 128, 1, 80)
    assert flash_ops.route(q, k, v) == "wgmma"
    o, lse = flash_ops.launch("wgmma", q, k, v, lse=True)
    torch.cuda.synchronize()
    ref = flash_ref(q, k, v)
    torch.testing.assert_close(o.float(), ref.float(), rtol=0, atol=FLASH_ATOL[torch.bfloat16])
    assert float((lse - flash_lse(q, k)).abs().max()) <= LSE_TOL
    _check_bwd(q, k, v, do, None, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 2])
def test_flash_d80_mma_sync_by_name_on_card(card, pad):
    """The kept mma_sync kernels at D = 80, launched by name on inputs the
    wgmma routes take (and on unaligned views), forward with its LSE and
    backward, against their plain versions."""
    q, k, v, do = _bwd_inputs(card, 2, 333, 8, 4, 80, torch.bfloat16, pad, seed=pad)
    o, lse = flash_ops.launch("mma_sync", q, k, v, lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), flash_ref(q, k, v).float(), rtol=0,
                               atol=FLASH_ATOL[torch.bfloat16])
    assert float((lse - flash_lse(q, k)).abs().max()) <= LSE_TOL
    got = flash_ops.launch_bwd("mma_sync", q, k, v, o, do, lse)
    _, err, row = flash_bwd_errors(got, flash_bwd_ref(q, k, v, o, do))
    assert err <= BWD_TOL[torch.bfloat16] and row <= BWD_ROW_REL


@pytest.mark.cuda
def test_flash_d80_float32_raises_naming_the_route(card):
    """float32 at D = 80 lies on no path: the fma routes have no D = 80
    tiling, and both directions raise, naming the route that takes D = 80,
    without launching anything."""
    q, k, v, do = _bwd_inputs(card, 1, 64, 4, 2, 80, torch.float32)
    launches = {n: c.launches for n, c in flash_ops.counts.items()}
    with pytest.raises(ValueError, match="wgmma and mma_sync routes only"):
        flash_ops.flash_attention(q, k, v)
    lse = torch.zeros((1, 4, 64), device=card)
    with pytest.raises(ValueError, match="wgmma and mma_sync routes only"):
        flash_ops.flash_attention_bwd(q, k, v, q, do, lse=lse)
    assert {n: c.launches for n, c in flash_ops.counts.items()} == launches


@pytest.mark.cuda
def test_zamba2_forward_backward_makes_no_host_sync(card):
    """A reduced zamba2 forward and backward (the chunked SSD's loop, the
    nested remat, the shared block's flash kernels) on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, in bf16 and f32: no host
    sync, and finite gradients."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.transformer import _leaves, loss_fn

    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_reduced("zamba2-2.7b"), dtype=dtype)
        params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(a).to(card)
                 for k, a in make_batch(cfg, ShapeConfig("t", "train", 64, 2), 0).items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            grads = torch.autograd.grad(loss_fn(params, batch, cfg), leaves)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_xlstm_forward_backward_makes_no_host_sync(card):
    """A reduced xLSTM forward and backward (the mLSTM's chunk loop, the
    sLSTM's position loop, each block rematerialized) on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, in bf16 and f32: no host
    sync, finite gradients, no flash call."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.transformer import _leaves, loss_fn

    flash_ops.reset_counts()
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_reduced("xlstm-125m"), dtype=dtype)
        params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(a).to(card)
                 for k, a in make_batch(cfg, ShapeConfig("t", "train", 64, 2), 0).items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            grads = torch.autograd.grad(loss_fn(params, batch, cfg), leaves)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(c.launches == c.plain_calls == 0 for c in flash_ops.counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_layer_on_card_matches_cpu(card, kind):
    """One mLSTM or sLSTM layer at the reduced width in f32 (the mLSTM at
    L = 48 in 3 chunks of 16), card against CPU from the same weights and
    inputs: the output, each leaf of the final state and the input's
    gradient to 1e-5 of max |CPU|."""
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import _leaves

    cfg = dataclasses.replace(get_reduced("xlstm-125m"), dtype="float32")
    init, apply = ((xlstm.mlstm_init, xlstm.mlstm_apply) if kind == "mlstm"
                   else (xlstm.slstm_init, xlstm.slstm_apply))
    p = init(torch.Generator().manual_seed(1), cfg, torch.float32)
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in (card, torch.device("cpu")):
        xd = x.to(dev).requires_grad_(True)
        y, state = apply({k: v.to(dev) for k, v in p.items()}, xd, cfg)
        (gx,) = torch.autograd.grad(y.square().sum(), [xd])
        out[dev.type] = [t.detach().cpu() for t in (y, gx, *_leaves(state))]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_flash_bwd_refuses_a_missing_lse(card):
    q, k, v, do = _bwd_inputs(card, 1, 64, 4, 2, 64, torch.bfloat16)
    o = flash_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        flash_ops.flash_attention_bwd(q, k, v, o, do)


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,D,pad", [
    ("wgmma", torch.bfloat16, 128, 0), ("wgmma", torch.bfloat16, 64, 0),
    ("mma_sync", torch.bfloat16, 128, 0), ("mma_sync", torch.bfloat16, 16, 2),
    ("mma_sync", torch.bfloat16, 80, 0), ("wgmma", torch.bfloat16, 80, 0),
    ("fma", torch.float32, 128, 0), ("fma", torch.float32, 16, 0), ("fma", torch.bfloat16, 8, 0),
])
@pytest.mark.parametrize("S,window", [(1, None), (77, None), (300, 48), (1000, None)])
def test_flash_forward_lse_on_card(card, route, dtype, D, pad, S, window):
    """Every forward route's LSE against the plain LSE (``ref.LSE_TOL``),
    and its o bitwise the o of the same route without the LSE."""
    q, k, v, _ = _bwd_inputs(card, 2, S, 4, 2, D, dtype, pad, seed=S + D)
    o, lse = flash_ops.launch(route, q, k, v, window=window, lse=True)
    o_plain = flash_ops.launch(route, q, k, v, window=window)
    torch.cuda.synchronize()
    assert lse.shape == (2, 4, S) and lse.dtype == torch.float32
    assert float((lse - flash_lse(q, k, window=window)).abs().max()) <= LSE_TOL
    assert torch.equal(o, o_plain)


@pytest.mark.cuda
def test_small_serve_on_card_matches_cpu(card):
    cfg = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
    host = init_params(torch.Generator().manual_seed(0), cfg)

    def numpy_tree(t):
        return {k: numpy_tree(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()

    arrays = numpy_tree(host)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (5, 9, 3, 12, 7)]
    out = {}
    for dev in (card, torch.device("cpu")):
        eng = ServeEngine(cfg, params=lm_params(arrays, cfg, device=dev), max_len=32,
                          max_batch=4, device=dev)
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        flash_ops.reset_counts()
        eng.generate(reqs)
        c = flash_ops.counts["flash_attention"]
        if dev.type == "cuda":  # f32: the FMA kernel
            assert (c.launches, c.plain_calls) == (2 * cfg.n_layers, 0)
            assert flash_ops.route_launches["fma"] == 2 * cfg.n_layers
        out[dev.type] = [r.out_tokens for r in reqs]
    assert out["cuda"] == out["cpu"]


def _service_requests():
    """Six requests at p=2, refine=1: fields, dicts, a repeated material."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    rng = np.random.default_rng(0)
    ne = spaces[-1].nelem
    field = (rng.lognormal(0, 0.5, ne), rng.lognormal(0, 0.5, ne))
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, field, {1: (10.0, 5.0), 2: (2.0, 2.0)},
            field, {1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 8.0), 2: (2.0, 1.5)}]
    tols = [1e-8, 1e-6, 1e-10, 1e-8, 1e-6, 1e-8]
    return [SolveRequest(p=2, refine=1, materials=m, traction=(0.0, 1e-3 * (i % 2), -1e-2),
                         rel_tol=t, keep_solution=True)
            for i, (m, t) in enumerate(zip(mats, tols))]


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "generational"])
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_small_service_on_card_matches_cpu(card, monkeypatch, precision, continuous):
    """The service on the card and on the CPU from the same start vectors:
    iterations, flags and stats equal; solutions within 1e-10 of max |x|
    in f64 (1e-6 under mixed, whose V-cycle runs in f32)."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    g = torch.Generator().manual_seed(0)
    sv = [torch.randn((sp.nscalar, 3), generator=g, dtype=torch.float64) for sp in spaces[1:]]
    monkeypatch.setattr(elasticity_service, "BatchedGMGSolver",
                        functools.partial(BatchedGMGSolver, start_vectors=sv))
    out, stats = {}, {}
    for name, dev in (("card", card), ("cpu", torch.device("cpu"))):
        svc = ElasticityService(max_batch=4, chunk_iters=3, precision=precision, device=dev)
        ops.reset_counts()
        reqs = _service_requests()
        out[name] = svc.solve_continuous(reqs) if continuous else svc.solve(reqs)
        stats[name] = dict(svc.stats)
        c = ops.counts["pa_elasticity"]
        if dev.type == "cuda":
            assert c.launches > 0 and c.plain_calls == 0
    assert stats["card"] == stats["cpu"]
    rtol = 1e-10 if precision == "f64" else 1e-6
    for a, b in zip(out["card"], out["cpu"], strict=True):
        assert (a.iterations, a.converged, a.batch_size, a.padded_rows, a.generation) == (
            b.iterations, b.converged, b.batch_size, b.padded_rows, b.generation)
        assert isinstance(a.x, np.ndarray) and a.converged
        np.testing.assert_allclose(a.x, b.x, rtol=rtol, atol=rtol * np.abs(b.x).max())


@pytest.mark.cuda
def test_take_rows_copy_prep_rows_bitwise_on_card(card):
    """take_rows gathers state and prep rows bitwise, and rows that keep
    their place resume bitwise.  A row that moves to another place resumes
    with the same iterations and x within 1e-12 of max |x|: the card's
    sum reduction treats a row's unaligned head apart, so a dot product's
    order depends on where the row starts.  copy_prep_rows gathers every
    source before it writes (a swap swaps) and leaves its input prep as
    it was."""
    solver = BatchedGMGSolver(beam_hex(), 1, 2, device=card)
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 5.0), 2: (2.0, 2.0)},
            {1: (20.0, 20.0), 2: (3.0, 1.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2], [0.0, 0.0, -5e-3]])
    tols = np.array([1e-10, 1e-9, 1e-10])
    lam, mu = solver.pack_materials(mats)
    ones = np.ones(3, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(3))
    state, _ = solver.run_chunk(trs, tols, ones, solver.empty_state(3), prep, 3, do_reset=True)
    full = state
    while bool(full.active.any()):
        full, _ = solver.run_chunk(trs, tols, ~ones, full, prep, 4)
    for rows in ([0, 1, 2], [2, 0, 0], [2, 0, 0, 1]):
        kept, kprep = solver.take_rows(state, prep, rows)
        for f in dataclasses.fields(kept):
            assert torch.equal(getattr(kept, f.name), getattr(state, f.name)[rows]), f.name
        assert torch.equal(kprep["chol"], prep["chol"][rows])
        while bool(kept.active.any()):
            kept, _ = solver.run_chunk(trs[rows], tols[rows], np.zeros(len(rows), bool), kept,
                                       kprep, 4)
        assert torch.equal(kept.iters, full.iters[rows])
        if rows == [0, 1, 2]:
            for f in dataclasses.fields(kept):
                assert torch.equal(getattr(kept, f.name), getattr(full, f.name)), f.name
        want = full.x[rows]
        torch.testing.assert_close(kept.x, want, rtol=0, atol=1e-12 * float(want.abs().max()))
    chol = prep["chol"].clone()
    swapped = solver.copy_prep_rows(prep, [0, 1], [1, 0])
    assert torch.equal(prep["chol"], chol)
    for key in ("lam_w", "mu_w", "dinv", "lmax"):
        for old, new in zip(prep[key], swapped[key]):
            assert torch.equal(new.reshape(3, -1)[[1, 0, 2]], old.reshape(3, -1))
    assert torch.equal(swapped["chol"][[1, 0, 2]], prep["chol"])


@pytest.mark.cuda
def test_sharded_host_copies_wait_for_queued_work_on_card(card):
    """A sharded state and prep on two virtual devices of the card, copied
    to the host as a checkpoint copies them (state_to_host, prep_to_host,
    gather_scenario, tree_to) while writes to their blocks are still
    queued behind a stalled stream, equal bitwise a blocking copy taken
    once the card is idle."""
    solver = BatchedGMGSolver(beam_hex(), 1, 2, device=card, mesh=(card,) * 2)
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 5.0), 2: (2.0, 2.0)},
            {1: (20.0, 20.0), 2: (3.0, 1.0)}, {1: (9.0, 9.0), 2: (1.0, 3.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2], [0.0, 0.0, -5e-3],
                    [0.0, 2e-3, -1e-2]])
    tols = np.full(4, 1e-10)
    lam, mu = solver.pack_materials(mats)
    ones = np.ones(4, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(4))
    state, _ = solver.run_chunk(trs, tols, ones, solver.empty_state(4), prep, 3, do_reset=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)  # ~0.25 s: what follows stays queued
    for leaf in (state.x, state.r, prep["chol"], prep["lam_w"][0]):
        for b in leaf.blocks:
            b.mul_(2.0)
    got = {"state": solver.state_to_host(state), "prep": solver.prep_to_host(prep),
           "gather": gather_scenario(state.r, "cpu").numpy(),
           "tree": tree_to({"x": state.x}, "cpu")["x"].numpy()}
    torch.cuda.synchronize()

    def blocking(leaf):
        return torch.cat([b.cpu() for b in getattr(leaf, "blocks", (leaf,))]).numpy()

    for f in dataclasses.fields(state):
        np.testing.assert_array_equal(got["state"][f.name], blocking(getattr(state, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(got["prep"]["chol"], blocking(prep["chol"]))
    np.testing.assert_array_equal(got["prep"]["lam_w0"], blocking(prep["lam_w"][0]))
    np.testing.assert_array_equal(got["gather"], blocking(state.r))
    np.testing.assert_array_equal(got["tree"], blocking(state.x))


class _ScriptedCrash(RuntimeError):
    """Stands in for process death inside ``step()``."""


@pytest.mark.cuda
def test_crash_restore_bitwise_on_card(card, tmp_path):
    """A service killed mid-chunk at step 2 and restored from its step-1
    checkpoint into a fresh service drains the undisturbed run's reports
    bitwise (iterations, flags, residual norms, solutions), through the
    kernels alone."""
    reqs = _service_requests()
    base = ElasticityService(max_batch=4, chunk_iters=3, device=card).solve_continuous(reqs)

    svc = ElasticityService(max_batch=4, chunk_iters=3, device=card)
    rec = ServiceRecovery(svc, str(tmp_path), every=1)
    inner = svc._launch_chunk

    def launch(flight):
        inner(flight)
        if svc._step_index == 2:
            raise _ScriptedCrash("mid-chunk at step 2")

    svc._launch_chunk = launch
    for r in reqs:
        svc.submit(r)
    with pytest.raises(_ScriptedCrash):
        while not svc.idle():
            svc.step()
            rec.maybe_checkpoint()
    svc2 = ElasticityService(max_batch=4, chunk_iters=3, device=card)
    rec2 = ServiceRecovery(svc2, str(tmp_path), every=1)
    ops.reset_counts()
    assert rec2.restore() and svc2._step_index == 1
    while not svc2.idle():
        svc2.step()
        rec2.maybe_checkpoint()
    c = ops.counts["pa_elasticity"]
    assert c.launches > 0 and c.plain_calls == 0 and ops.counts["probe"].launches > 0
    got = {r.ticket: r for r in svc2.drain()}
    assert sorted(got) == list(range(len(reqs)))
    for t, want in enumerate(base):
        g = got[t]
        assert (g.iterations, g.converged, g.final_rel_norm) == (
            want.iterations, want.converged, want.final_rel_norm), t
        assert np.array_equal(g.x, want.x), t
    assert svc2.stats["restores"] == 1


@pytest.mark.cuda
def test_state_host_roundtrip_bitwise_on_card(card):
    """state_to_host -> state_from_host and prep_to_host ->
    prep_from_host give the card's tensors back bitwise, on the card, and
    a chunk from the restored pair is bitwise the original's."""
    solver = BatchedGMGSolver(beam_hex(), 1, 2, device=card)
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 5.0), 2: (2.0, 2.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2]])
    lam, mu = solver.pack_materials(mats)
    ones = np.ones(2, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(2))
    state, _ = solver.run_chunk(trs, 1e-10, ones, solver.empty_state(2), prep, 3, do_reset=True)
    state2 = solver.state_from_host(solver.state_to_host(state))
    prep2 = solver.prep_from_host(solver.prep_to_host(prep))
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(state2, f.name)
        assert b.device == a.device and torch.equal(a, b), f.name
    for key, val in prep.items():
        for a, b in zip(val if isinstance(val, tuple) else (val,),
                        prep2[key] if isinstance(val, tuple) else (prep2[key],)):
            assert b.device == a.device and torch.equal(a, b), key
    nxt, _ = solver.run_chunk(trs, 1e-10, ~ones, state, prep, 4)
    nxt2, _ = solver.run_chunk(trs, 1e-10, ~ones, state2, prep2, 4)
    assert torch.equal(nxt.x, nxt2.x) and torch.equal(nxt.iters, nxt2.iters)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("level", ASSEMBLY_LEVELS)
def test_assembly_level_on_card_matches_cpu(card, level, p):
    """Every level of the ladder: its apply on the card equals the same
    level on the CPU and paop_cuda on the card (f64 tolerances)."""
    rtol, atol = TOL[torch.float64]
    space = H1Space(beam_hex().refined(1 if p < 4 else 0), p)
    x = torch.randn((2, space.nscalar, 3), generator=torch.Generator().manual_seed(p),
                    dtype=torch.float64)
    mats = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (10.0, 5.0), 2: (2.0, 2.0)}]
    if level == "fa":  # one scenario only
        mats, x = mats[0], x[0]
    y = ElasticityOperator(space, assembly=level, materials=mats, device=card).apply(
        x.to(card))
    want = ElasticityOperator(space, assembly=level, materials=mats, device="cpu").apply(x)
    torch.testing.assert_close(y.cpu(), want, rtol=rtol, atol=atol * float(want.abs().max()))
    fused = ElasticityOperator(space, assembly="paop_cuda", materials=mats,
                               device=card).apply(x.to(card))
    torch.testing.assert_close(y, fused, rtol=rtol, atol=atol * float(fused.abs().max()))


@pytest.mark.cuda
def test_fa_spmv_bitwise_repeatable_on_card(card):
    op = ElasticityOperator(H1Space(beam_hex().refined(2), 2), assembly="fa", device=card)
    x = torch.randn((op.space.nscalar, 3), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64).to(card)
    y = op.apply(x)
    assert all(torch.equal(op.apply(x), y) for _ in range(3))


@pytest.mark.cuda
def test_throughput_row_on_card(card):
    before = ops.counts["pa_elasticity"].launches
    row = operator_throughput(4, 2, assembly="paop_cuda", device=card, repeats=1)
    assert ops.counts["pa_elasticity"].launches > before
    assert (row["route"], row["device"]) == ("cuda", torch.cuda.get_device_name(card))
    assert row["t_apply_s"] > 0 and row["placement"]["hw"] == "nvidia-h100-sxm"
    assert 0 < row["placement"]["fraction"] < 1
    plain = operator_throughput(4, 2, assembly="pa_baseline", device=card, repeats=1)
    assert plain["route"] == "plain" and plain["placement"]["bound"] == "compute"


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_device_time_by_category_puts_backward_in_its_range(card, remat):
    """tanh(a * b) inside a record_function range, its result through exp
    and a sum outside it, then the backward.  The range's category gets the
    range's forward launches, under checkpoint their recompute too, and
    the launches of their backward (each count measured on its own, without
    ranges); every other launch of the run falls to ``other``."""
    g = torch.Generator(device=card).manual_seed(0)
    a, b = (torch.randn((1024, 1024), device=card, generator=g).requires_grad_()
            for _ in range(2))

    def inside(x, y):
        with record_function("test.inside"):
            return torch.tanh(x * y)

    def run():
        # the whole recompute, not stopped once the saved tensors exist
        with set_checkpoint_early_stop(False):
            h = checkpoint(inside, a, b, use_reentrant=False) if remat else inside(a, b)
            torch.exp(h).sum().backward()
        torch.cuda.synchronize()

    def launches(fn, ranges=None):
        a.grad = b.grad = None
        return device_time_by_category(fn, {}, ranges)[1]

    def forward():
        with torch.no_grad():
            inside(a, b)
        torch.cuda.synchronize()

    run()  # warm-up: the first launches of a kernel are not what is measured
    n_fwd = launches(forward)["other"]
    h = inside(a, b)
    dh = torch.ones_like(h)
    n_bwd = launches(lambda: (torch.autograd.backward(h, dh), torch.cuda.synchronize()))["other"]
    total = launches(run)["other"]
    count = launches(run, {"inside": "test.inside"})
    assert n_fwd >= 2 and n_bwd >= 3
    assert count["inside"] == n_fwd * (1 + remat) + n_bwd, (n_fwd, n_bwd, count)
    assert count["other"] == total - count["inside"] > 0, (total, count)
    torch.testing.assert_close(a.grad, b * torch.exp(torch.tanh(a * b))
                               * (1 - torch.tanh(a * b) ** 2))


def _moe_cfg(arch, **kw):
    return dataclasses.replace(get_reduced(arch), dtype="float32", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_on_card_matches_cpu(card, arch, cf):
    """moe_apply at the reduced width in f32, card against CPU: the same
    expert ids and dropped assignments, y to 1e-5 of max |y|, aux to 1e-6."""
    cfg = _moe_cfg(arch, capacity_factor=cf)
    p = moe.moe_init(torch.Generator().manual_seed(1), cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in (card, torch.device("cpu")):
        xd, pd = x.to(dev), {k: v.to(dev) for k, v in p.items()}
        _, _, idx = moe.route(pd, xd, cfg)
        keep = moe.slots(idx, cfg.n_experts, moe.capacity(cfg, x.shape[1]))[2]
        y, aux = moe.moe_apply(pd, xd, cfg)
        out[dev.type] = (idx.cpu(), keep.cpu(), y.cpu(), float(aux))
    (ic, kc, yc, ac), (ih, kh, yh, ah) = out["cuda"], out["cpu"]
    assert torch.equal(ic, ih) and torch.equal(kc, kh)
    assert cf > 1 or bool((~kh).any())  # at 0.25 some assignments are dropped
    assert float((yc - yh).abs().max()) <= 1e-5 * float(yh.abs().max())
    assert abs(ac - ah) <= 1e-6 * abs(ah)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_train_step_is_bitwise_repeatable_on_card(card, dtype):
    """One reduced olmoe-1b-7b train step at capacity factor 0.25 (so that
    assignments are dropped), run twice from one state: the same loss,
    gradients and updated parameters, bit for bit."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.transformer import _leaves, loss_fn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import make_train_step, train_state_init

    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype=dtype, capacity_factor=0.25)
    host = init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(a).to(card)
             for k, a in make_batch(cfg, ShapeConfig("t", "train", 64, 2), 0).items()}
    step = make_train_step(cfg, AdamWConfig(total_steps=3, warmup_steps=1))
    runs = []
    for _ in range(2):
        state = train_state_init(None, cfg, params=lm_params(_numpy(host), cfg, device=card))
        leaves = list(_leaves(state.params))
        grads = torch.autograd.grad(loss_fn(state.params, batch, cfg), leaves)
        state, m = step(state, batch)
        runs.append((m["loss"], grads, [p.detach().clone() for p in _leaves(state.params)]))
    (l0, g0, p0), (l1, g1, p1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def _numpy(t):
    return {k: _numpy(v) for k, v in t.items()} if isinstance(t, dict) else t.float().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_small_moe_serve_on_card_matches_cpu(card, arch):
    """The reduced MoE configurations in f32 served on the card and on the
    CPU from the same weights: the same greedy tokens."""
    cfg = _moe_cfg(arch)
    arrays = _numpy(init_params(torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (5, 9, 3, 12, 7)]
    out = {}
    for dev in (card, torch.device("cpu")):
        eng = ServeEngine(cfg, params=lm_params(arrays, cfg, device=dev), max_len=32,
                          max_batch=4, device=dev)
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        eng.generate(reqs)
        out[dev.type] = [r.out_tokens for r in reqs]
    assert out["cuda"] == out["cpu"]


def _mesh_step_on(cfg, host, device, seq_parallel: bool = False):
    """One train step of ``cfg`` from the parameters ``host`` (numpy) on a
    (2, 2) mesh of four virtual ``device``s (``seq_parallel``: with the
    reference's act_spec and logits_spec); (metrics, gathered host
    state)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import P, act_pspec, gather
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import make_train_step, train_state_init

    mesh = make_local_mesh(2, devices=(device,) * 4)
    specs = ({"act_spec": act_pspec(mesh.axis_names), "logits_spec": P("data", None, "model")}
             if seq_parallel else {})
    state = train_state_init(None, cfg, params=lm_params(host, cfg, device=device), mesh=mesh)
    batch = {k: torch.from_numpy(a)
             for k, a in make_batch(cfg, ShapeConfig("t", "train", 64, 4), 0).items()}
    state, m = make_train_step(cfg, AdamWConfig(total_steps=3, warmup_steps=1), mesh=mesh,
                               **specs)(state, batch)
    return {k: float(v) for k, v in m.items()}, gather(state, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_mesh_train_step_on_card_matches_cpu_and_repeats(card, arch):
    """The reduced configuration in f32 on a (2, 2) mesh of four virtual
    devices of the card (tensor parallel attention and MLP, or expert
    parallel MoE, through the flash kernels) against the same mesh of CPU
    devices from the same weights: loss, grad norm and every moment leaf
    within 1e-5 of max |CPU|; two runs on the card bitwise equal."""
    from repro_torch.models.transformer import _leaves

    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    host = _numpy(init_params(torch.Generator().manual_seed(0), cfg))
    (mc, sc), (mc2, sc2) = (_mesh_step_on(cfg, host, card) for _ in range(2))
    mh, sh = _mesh_step_on(cfg, host, torch.device("cpu"))
    for k in ("loss", "grad_norm"):
        assert abs(mc[k] - mh[k]) <= 1e-5 * abs(mh[k]), (k, mc[k], mh[k])
    for a, b in zip(_leaves(sc.opt_state), _leaves(sh.opt_state)):
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * max(
            float(b.float().abs().max()), 1e-30)
    assert mc == mc2
    assert all(torch.equal(a, b) for a, b in zip(_leaves([sc.params, sc.opt_state]),
                                                 _leaves([sc2.params, sc2.opt_state])))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "zamba2-2.7b"])
def test_sequence_parallel_step_on_card_matches_cpu_and_repeats(card, arch):
    """The same with sequence parallelism and the vocab-parallel CE: card
    against CPU within 1e-5 of max |CPU| (loss, grad norm, every moment
    leaf), two runs on the card bitwise equal."""
    from repro_torch.models.transformer import _leaves

    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    host = _numpy(init_params(torch.Generator().manual_seed(0), cfg))
    (mc, sc), (mc2, sc2) = (_mesh_step_on(cfg, host, card, True) for _ in range(2))
    mh, sh = _mesh_step_on(cfg, host, torch.device("cpu"), True)
    for k in ("loss", "grad_norm"):
        assert abs(mc[k] - mh[k]) <= 1e-5 * abs(mh[k]), (k, mc[k], mh[k])
    for a, b in zip(_leaves(sc.opt_state), _leaves(sh.opt_state)):
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * max(
            float(b.float().abs().max()), 1e-30)
    assert mc == mc2
    assert all(torch.equal(a, b) for a, b in zip(_leaves([sc.params, sc.opt_state]),
                                                 _leaves([sc2.params, sc2.opt_state])))


def _tree_slice(tree, s):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, s) for k, v in tree.items()}
    return tree[s]


@pytest.mark.cuda
def test_pipeline_on_card_is_the_sequential_apply_bitwise(card):
    """qwen3-1.7b reduced in bf16 (the mma_sync flash route), its 2 blocks
    as 2 stages on two virtual devices of the card, 4 microbatches,
    forward and gradient."""
    from repro_torch.distributed.pipeline import pipeline_apply, split_stages
    from repro_torch.distributed.sharding import LMMesh
    from repro_torch.models.transformer import _block_x, _leaves, _positions, _unstack

    cfg = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="bfloat16")
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
    leaves = [t.requires_grad_(True) for t in _leaves(params["blocks"])]
    staged = split_stages(params["blocks"], 2)
    tokens = torch.randint(0, cfg.vocab, (4, 64), device=card,
                           generator=torch.Generator(device=card).manual_seed(1))
    x = params["embed"][tokens].detach()
    pos = _positions({"tokens": tokens[:1]}, cfg)

    def stage(p, xm):
        for layer in _unstack(p, p["attn_norm"].shape[0]):
            xm = _block_x(layer, xm, cfg, pos)[0]
        return xm

    devs = np.empty(2, dtype=object)
    devs[:] = [card, card]
    mesh = LMMesh(devs.reshape(2, 1, 1), ("pod", "data", "model"))
    got = pipeline_apply(stage, staged, x, mesh=mesh, n_micro=4)
    outs = []
    for xm in x.reshape(4, 1, *x.shape[1:]):
        for s in range(2):
            xm = stage(_tree_slice(staged, s), xm)
        outs.append(xm)
    want = torch.stack(outs).reshape(x.shape)
    assert torch.equal(got, want)
    cot = torch.randn_like(got)
    for a, b in zip(torch.autograd.grad(got, leaves, cot), torch.autograd.grad(want, leaves, cot)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mesh_prefill_on_card_repeats_bitwise(card):
    """qwen3-1.7b reduced in bf16 (the mma_sync flash route) on a (2, 2)
    mesh of four virtual devices of the card: mesh_prefill twice, logits
    and every block of the sequence-split cache bitwise equal, one flash
    launch a device a layer and no plain call; one decode step's logits
    within 2^-5 of max |logit| of the unsharded decode_step on the card."""
    from repro_torch.distributed.sharding import param_pspecs, place
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import decode_step, mesh_decode_step, mesh_prefill, prefill

    cfg = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="bfloat16")
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
    mesh = make_local_mesh(2, devices=(card,) * 4)
    sp = place(params, param_pspecs(params, mesh), mesh)
    tokens = torch.randint(0, cfg.vocab, (4, 64), device=card,
                           generator=torch.Generator(device=card).manual_seed(1))
    runs = []
    with torch.inference_mode():
        for _ in range(2):
            flash_ops.reset_counts()
            runs.append(mesh_prefill(sp, {"tokens": tokens}, cfg, mesh, max_len=72))
            counts = flash_ops.counts["flash_attention"]
            assert (counts.launches, counts.plain_calls) == (4 * cfg.n_layers, 0)
        (l1, s1), (l2, s2) = runs
        assert torch.equal(l1, l2)
        assert all(torch.equal(a, b) for n in ("k", "v")
                   for a, b in zip(s1[n].blocks, s2[n].blocks))
        tok = l1.argmax(-1)[:, None]
        got, _ = mesh_decode_step(sp, tok, s1, 64, cfg, mesh)
        _, whole = prefill(params, {"tokens": tokens}, cfg, max_len=72)
        want, _ = decode_step(params, tok, whole, 64, cfg)
    assert float((got - want).float().abs().max()) <= 2.0 ** -5 * float(want.float().abs().max())


@pytest.mark.cuda
def test_elasticity_cell_on_card_is_the_operator(card):
    """The beam_p2_6m cell (f32, paop_cuda) on a (1, 1) mesh of the card:
    one PAop launch, no plain call, and the operator's apply on the same
    vector (the cell's own path: equal to 1e-5 of max |y|)."""
    from repro_torch.configs.elasticity import ELASTICITY_SHAPES
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, devices=(card,))
    cell = build_cell("elasticity", "beam_p2_6m", mesh, assembly="paop_cuda", seed=0)
    ops.reset_counts()
    (y,) = cell.run()
    assert (ops.counts["pa_elasticity"].launches, ops.counts["pa_elasticity"].plain_calls) == (1, 0)
    es = ELASTICITY_SHAPES["beam_p2_6m"]
    space = H1Space(beam_hex().refined(es.n_h_refine), es.p)
    want = ElasticityOperator(space, "paop_cuda", dtype=torch.float32, device=card).apply(
        cell.args[0][0])
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
