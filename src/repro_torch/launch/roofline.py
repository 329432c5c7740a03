"""Roofline placement of a measured operator apply, and the model FLOPs of
an LM cell.

A :class:`HardwareSpec` holds a card's memory rate and peak arithmetic
rates; :func:`place_measured` puts one measured apply (its analytic
FLOPs and streamed bytes, and its fenced wall time) on that card's
roofline.  The peak is chosen by the dtype of the measurement: an H100's
f64 rate (tensor cores) and its bf16 rate differ by 15x, so one number
would misplace every f64 row.

:data:`H100_SXM` takes NVIDIA's data-sheet numbers for the SXM part at
its full 700 W (dense rates, no sparsity), the constants ``chip_smoke.py``
bounds the kernels with.  A card set to a lower power limit reaches less;
every measured row names its card.

:func:`model_flops_estimate` is the reference's useful-FLOPs count (6 N T
for training, 2 N T for prefill, 2 N a row for decode, N the active
parameters); MFU divides it by a step's time and the peak.

:class:`RooflineTerms` and :func:`roofline_from_artifacts` are the
reference's three predicted time terms of a dry-run cell, per device:

    compute term    = FLOPs per device / the peak of the cell's dtype
    memory term     = bytes per device / HBM rate
    collective term = link bytes per device / NVLink rate

from the cost model's counts (:mod:`repro_torch.launch.jaxpr_cost`) and
the collectives' own tally (:func:`repro_torch.distributed.collectives.tally`,
the counterpart of the reference's ``collective_bytes``, which parses
HLO text: the port has none to parse).  The reference's ``V5E`` constants
have no counterpart: every term here is on an H100.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, get_config

__all__ = ["HardwareSpec", "H100_SXM", "MeasuredPlacement", "place_measured",
           "model_flops_estimate", "RooflineTerms", "roofline_from_artifacts"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # FLOP/s per chip; used only when there is no table
    hbm_bw: float  # bytes/s per chip
    link_bw: float  # bytes/s per link
    peak_flops_by_dtype: tuple[tuple[torch.dtype, float], ...] = ()

    def peak(self, dtype: torch.dtype | None = None) -> float:
        """Peak FLOP/s for ``dtype``.  A spec with a per-dtype table
        refuses a dtype it does not list (``None`` included): falling back
        to one number would place an f64 row against the bf16 roof."""
        if not self.peak_flops_by_dtype:
            return self.peak_flops
        table = dict(self.peak_flops_by_dtype)
        if dtype not in table:
            raise ValueError(
                f"{self.name} has peaks for {sorted(str(d) for d in table)}; "
                f"name the measurement's dtype, got {dtype}"
            )
        return table[dtype]


H100_SXM = HardwareSpec(
    "nvidia-h100-sxm",
    peak_flops=989e12,  # bf16 / fp16 tensor cores
    hbm_bw=3.35e12,  # HBM3
    link_bw=450e9,  # NVLink 4, one direction of 900 GB/s
    peak_flops_by_dtype=(
        (torch.float64, 67e12),  # tensor cores
        (torch.float32, 67e12),  # outside the tensor cores
        (torch.bfloat16, 989e12),
        (torch.float16, 989e12),
    ),
)


@dataclasses.dataclass(frozen=True)
class MeasuredPlacement:
    """A *measured* operator apply placed on the roofline: its analytic
    operational intensity, the roof that OI allows on the target
    hardware, and the fraction of it the measurement achieved."""

    oi: float  # analytic FLOPs/byte of the measured apply
    achieved_flops: float  # model FLOPs / measured seconds (FLOP/s)
    achieved_bw: float  # model streamed bytes / measured seconds (B/s)
    roof_flops: float  # min(peak, oi * hbm_bw) * chips (FLOP/s)
    fraction: float  # achieved_flops / roof_flops
    bound: str  # which ceiling binds at this OI: "memory" | "compute"
    hw: HardwareSpec


def place_measured(
    *,
    flops_per_apply: float,
    bytes_per_apply: float,
    t_apply_s: float,
    hw: HardwareSpec,
    dtype: torch.dtype | None = None,
    chips: int = 1,
) -> MeasuredPlacement:
    """Place one measured operator apply against ``hw``'s roofline at the
    peak of ``dtype`` (required when ``hw`` has a per-dtype table, see
    :meth:`HardwareSpec.peak`).  ``flops_per_apply`` / ``bytes_per_apply``
    are the analytic models; ``t_apply_s`` the fenced wall time of one
    apply."""
    if t_apply_s <= 0:
        raise ValueError(f"t_apply_s must be > 0, got {t_apply_s}")
    if bytes_per_apply <= 0:
        raise ValueError(f"bytes_per_apply must be > 0, got {bytes_per_apply}")
    peak = hw.peak(dtype)
    oi = flops_per_apply / bytes_per_apply
    roof = min(peak, oi * hw.hbm_bw) * chips
    return MeasuredPlacement(
        oi=oi,
        achieved_flops=flops_per_apply / t_apply_s,
        achieved_bw=bytes_per_apply / t_apply_s,
        roof_flops=roof,
        fraction=(flops_per_apply / t_apply_s) / roof,
        bound="memory" if oi * hw.hbm_bw < peak else "compute",
        hw=hw,
    )


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    link_bytes_per_dev: float
    operand_bytes_per_dev: float
    model_flops: float  # global useful FLOPs (6*N*D etc.)
    chips: int
    per_op: dict

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs (remat and redundancy waste:
        a block computed replicated over the model axis counts once a
        device)."""
        counted = self.flops_per_dev * self.chips
        return self.model_flops / counted if counted else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of the compute roof: compute term over the
        binding term (1.0 = compute-bound at peak)."""
        return self.compute_s / self.bound_s if self.bound_s else float("nan")


def roofline_from_artifacts(
    *,
    flops_per_dev: float,
    bytes_per_dev: float,
    chips: int,
    model_flops: float,
    coll: dict,
    dtype: torch.dtype,
    hw: HardwareSpec = H100_SXM,
) -> RooflineTerms:
    """The three terms of a dry-run cell on ``hw``: its per-device counts,
    ``coll`` the tally's per-device dict (``operand_bytes``, ``link_bytes``,
    ``per_op``), the compute term at the peak of ``dtype``."""
    return RooflineTerms(
        compute_s=flops_per_dev / hw.peak(dtype),
        memory_s=bytes_per_dev / hw.hbm_bw,
        collective_s=coll["link_bytes"] / hw.link_bw,
        flops_per_dev=flops_per_dev,
        bytes_per_dev=bytes_per_dev,
        link_bytes_per_dev=coll["link_bytes"],
        operand_bytes_per_dev=coll["operand_bytes"],
        model_flops=model_flops,
        chips=chips,
        per_op=coll.get("per_op", {}),
    )


def model_flops_estimate(arch: str | ArchConfig, shape: str | ShapeConfig,
                         meta: dict | None = None) -> float:
    """Useful FLOPs of one step of ``shape`` (a ``SHAPES`` name, or a
    ``ShapeConfig`` such as a cut batch): 6 N T to train, 2 N T to prefill,
    2 N a row to decode, N = ``n_active_params()`` (an MoE counts top_k of
    its n_experts) and T = seq_len x global_batch.  ``arch`` is an
    architecture id or an ``ArchConfig`` (such as one with its layers cut).
    ``arch == "elasticity"``: ``meta``'s ``flops_per_elem`` x ``nelem`` (0
    where absent), as in the reference."""
    if arch == "elasticity":
        meta = meta or {}
        return meta.get("flops_per_elem", 0.0) * meta.get("nelem", 0)
    n = (arch if isinstance(arch, ArchConfig) else get_config(arch)).n_active_params()
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per row
