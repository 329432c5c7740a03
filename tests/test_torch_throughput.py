"""Operator throughput, roofline placement and the elasticity config: the
port vs the reference, on the CPU.

The analytic models (streaming bytes, PAop and dense FLOPs) equal the
reference's for p = 1..8; ``place_measured`` gives the reference's
numbers on a ``HardwareSpec`` with the same constants, and the H100 spec
picks its peak by dtype; ``operator_throughput(device="cpu")`` with an
injected clock gives the reference row's model fields; the port's
``configs/elasticity.py`` is the reference's.  No time measured here is
a device metric: the clock is a counter."""

import dataclasses
import itertools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import elasticity as ref_cfg
from repro.core.flops import dense_flops_per_elem as ref_dense_flops
from repro.launch.roofline import V5E, model_flops_estimate as ref_model_flops
from repro.launch.roofline import place_measured as ref_place
from repro.obs import throughput as ref_tp
from repro_torch.configs import elasticity as cfg
from repro_torch.core.flops import dense_flops_per_elem, dense_gemm_flops_per_elem
from repro_torch.core.pa_baseline import dense_grad_table
from repro_torch.core.operators import ElasticityOperator
from repro_torch.fem.mesh import beam_hex
from repro_torch.fem.space import H1Space
from repro_torch.configs.base import PORTED, SHAPES, ShapeConfig
from repro_torch.launch.roofline import (
    H100_SXM, HardwareSpec, model_flops_estimate, place_measured)
from repro_torch.obs import model_flops_per_elem, operator_throughput, streaming_bytes_per_elem

MODEL_KEYS = ("p", "refine", "batch", "assembly", "dtype", "precision_policy", "ndof",
              "nelem", "dofs", "bytes_per_apply", "flops_per_apply", "oi_model")


def _clock(step=0.01):
    ticks = itertools.count()
    return lambda: next(ticks) * step


@pytest.mark.parametrize("p", range(1, 9))
def test_models_match_reference(p):
    for itemsize in (4, 8):
        assert streaming_bytes_per_elem(p, itemsize) == ref_tp.streaming_bytes_per_elem(
            p, itemsize)
        assert streaming_bytes_per_elem(p, itemsize, p + 3) == (
            ref_tp.streaming_bytes_per_elem(p, itemsize, p + 3))
    for a in ("pa_baseline", "pa_sumfact", "paop", "paop_cuda"):
        assert model_flops_per_elem(p, a) == ref_tp.model_flops_per_elem(p, a)
    assert dense_flops_per_elem(p) == ref_dense_flops(p)
    assert dense_flops_per_elem(p, p + 3) == ref_dense_flops(p, p + 3)


@pytest.mark.parametrize("p", [1, 4, 8])
def test_dense_gemm_flops_count_the_baselines_contractions(p):
    """The FLOPs of pa_baseline's two dense contractions, as PyTorch's
    counter reads them, and a third of the reference's dense model."""
    ne, g3d = 2, dense_grad_table(p)
    xf = torch.zeros((ne, 3, g3d.shape[2]), dtype=torch.float64)
    qvec = torch.zeros((ne, 3, 3, g3d.shape[1]), dtype=torch.float64)
    with FlopCounterMode(display=False) as counter:
        torch.einsum("mqL,ecL->ecmq", g3d, xf)
        torch.einsum("ecmq,mqL->ecL", qvec, g3d)
    assert counter.get_total_flops() == dense_gemm_flops_per_elem(p) * ne
    assert 3 * dense_gemm_flops_per_elem(p) == dense_flops_per_elem(p)


@pytest.mark.parametrize("flops, nbytes, t", [
    (1e9, 1e9, 1e-3),  # memory-bound on both specs
    (5e12, 1e9, 0.5),  # compute-bound
    (2.92e6 * 32768, 6432 * 32768, 3.1e-4),  # PAop p=4, NE=32,768, f64
])
def test_place_measured_matches_reference(flops, nbytes, t):
    spec = HardwareSpec(V5E.name, V5E.peak_flops, V5E.hbm_bw, V5E.link_bw)
    for chips in (1, 4):
        got = place_measured(flops_per_apply=flops, bytes_per_apply=nbytes,
                             t_apply_s=t, hw=spec, chips=chips)
        want = ref_place(flops_per_apply=flops, bytes_per_apply=nbytes,
                         t_apply_s=t, hw=V5E, chips=chips)
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        g.pop("hw"), w.pop("hw")
        assert g == w
    with pytest.raises(ValueError, match="t_apply_s"):
        place_measured(flops_per_apply=1.0, bytes_per_apply=1.0, t_apply_s=0.0, hw=spec)
    with pytest.raises(ValueError, match="bytes_per_apply"):
        place_measured(flops_per_apply=1.0, bytes_per_apply=0.0, t_apply_s=1.0, hw=spec)


def test_h100_peak_is_chosen_by_dtype():
    assert H100_SXM.hbm_bw == 3.35e12
    assert H100_SXM.peak(torch.float64) == H100_SXM.peak(torch.float32) == 67e12
    assert H100_SXM.peak(torch.bfloat16) == 989e12
    # OI 50 FLOP/B: compute-bound in f64 (roof 67 TFLOP/s), memory-bound in
    # bf16 (roof 167.5 TFLOP/s) on the same card
    kw = dict(flops_per_apply=50e9, bytes_per_apply=1e9, t_apply_s=1e-2, hw=H100_SXM)
    f64 = place_measured(dtype=torch.float64, **kw)
    bf16 = place_measured(dtype=torch.bfloat16, **kw)
    assert (f64.bound, f64.roof_flops) == ("compute", 67e12)
    assert (bf16.bound, bf16.roof_flops) == ("memory", 50 * 3.35e12)
    assert f64.fraction == pytest.approx(5e12 / 67e12)
    # a measurement without its dtype, or with one the table lacks, is refused
    for dtype in (None, torch.int8):
        with pytest.raises(ValueError, match="dtype"):
            place_measured(dtype=dtype, **kw)


@pytest.mark.parametrize("p, refine, batch, assembly", [
    (1, 0, 1, "paop"),
    (2, 1, 2, "pa_baseline"),
    (2, 0, 1, "pa_sumfact_voigt"),
])
def test_operator_throughput_row_matches_reference(p, refine, batch, assembly):
    want = ref_tp.operator_throughput(p, refine, batch, assembly=assembly, repeats=1,
                                      clock=_clock())
    got = operator_throughput(p, refine, batch, assembly=assembly, device="cpu",
                              repeats=3, clock=_clock())
    assert {k: got[k] for k in MODEL_KEYS} == {k: want[k] for k in MODEL_KEYS}
    # the counting clock advances 0.01 s a call
    assert got["t_apply_s"] == pytest.approx(0.01)
    assert (got["route"], got["device"]) == ("plain", "cpu")
    pl = got["placement"]
    # the dense contraction's OI (~80 FLOP/B at p=2) is past the f64 ridge (20)
    assert pl["hw"] == H100_SXM.name
    assert pl["bound"] == ("compute" if assembly == "pa_baseline" else "memory")
    assert pl["oi"] == pytest.approx(got["oi_model"])
    assert pl["achieved_flops"] == pytest.approx(got["flops_per_apply"] / got["t_apply_s"])


def test_operator_throughput_fa_row():
    row = operator_throughput(1, 1, assembly="fa", device="cpu", repeats=1, clock=_clock())
    op = ElasticityOperator(H1Space(beam_hex().refined(), 1), assembly="fa",
                            materials={1: (50.0, 50.0), 2: (1.0, 1.0)}, device="cpu")
    assert row["flops_per_apply"] == 2.0 * op._sparse.nnz
    assert row["bytes_per_apply"] == op.memory_bytes() + 2 * row["ndof"] * 8
    assert (row["assembly"], row["batch"], row["route"]) == ("fa", 1, "plain")
    with pytest.raises(ValueError, match="one scenario"):
        operator_throughput(1, 0, 2, assembly="fa", device="cpu")


def test_elasticity_config_matches_reference():
    assert dataclasses.asdict(cfg.CONFIG) == dataclasses.asdict(ref_cfg.CONFIG)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref_cfg.reduced())
    assert {k: dataclasses.asdict(v) for k, v in cfg.ELASTICITY_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_cfg.ELASTICITY_SHAPES.items()}
    # the paper's scales: 6.5M DoFs at p=2/r=5 and p=8/r=3, 51.17M at p=8/r=4
    ndof = {k: H1Space(beam_hex().refined(s.n_h_refine), s.p).ndof
            for k, s in cfg.ELASTICITY_SHAPES.items()}
    assert ndof["beam_p8_6m"] == 6_502_275 and ndof["beam_p8_51m"] == 51_171_075
    assert ndof["beam_p2_6m"] == 6_502_275


@pytest.mark.parametrize("arch", PORTED)
def test_model_flops_estimate_matches_reference(arch):
    """6 N T to train, 2 N T to prefill, 2 N a row to decode (N the
    active parameters), equal to the reference's for every SHAPES entry; a
    ShapeConfig with a cut batch scales with it."""
    for name, shape in SHAPES.items():
        assert model_flops_estimate(arch, name, {}) == ref_model_flops(arch, name, {})
        cut = dataclasses.replace(shape, global_batch=4)
        assert model_flops_estimate(arch, cut) == ref_model_flops(arch, name, {}) * 4 / (
            shape.global_batch)
    assert model_flops_estimate(arch, ShapeConfig("t", "train", 4096, 4)) == (
        6.0 * 4096 * 4 * ref_model_flops(arch, "decode_32k", {}) / 2.0 / 128)


def test_model_flops_estimate_of_elasticity():
    meta = {"flops_per_elem": 1234.5, "nelem": 32768}
    assert model_flops_estimate("elasticity", "train_4k", meta) == ref_model_flops(
        "elasticity", "train_4k", meta) == 1234.5 * 32768
    assert model_flops_estimate("elasticity", "train_4k", {}) == 0.0
