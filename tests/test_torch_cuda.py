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

from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params
from repro_torch.core.basis import basis_tables
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_ref
from repro_torch.kernels.pa_elasticity import build, ops
from repro_torch.kernels.pa_elasticity.ref import paop_ref
from repro_torch.launch.solve import solve_beam
from repro_torch.fem.mesh import beam_hex
from repro_torch.models.transformer import init_params
from repro_torch.serve import elasticity_service
from repro_torch.serve.elasticity_service import ElasticityService, SolveRequest
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
    """The kernel ops.route must pick: bf16 at D in {64, 128} with 16-byte
    rows takes wgmma, other bf16 at D >= 16 mma_sync, the rest fma."""
    if dtype == torch.bfloat16 and D in (64, 128) and pad == 0:
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
