"""The port's CUDA kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip without a card.  This
file imports neither jax nor the reference package, so on the card it
runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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
from repro_torch.serve.engine import Request, ServeEngine
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
