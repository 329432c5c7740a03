"""Operator-apply throughput on the batched path, placed on a roofline.

Measures what the paper's Fig. 5 measures — operator applications per
second, expressed as DoF/s — on the operator the solvers run: S
scenarios' material fields folded into the element axis of one
:class:`~repro_torch.core.operators.ElasticityOperator`, as
``BatchedGMGSolver`` binds them inside a solve.  ``apply`` is the whole
L-vector action (gather, element operator, deterministic scatter).  Next
to the wall measurement it evaluates the paper's analytic models, so
every row carries its own roofline placement:

* ``flops_per_apply`` — :func:`repro_torch.core.flops.paop_flops_per_elem`
  (or the dense-baseline count for ``pa_baseline``) x elements;
* ``bytes_per_apply`` — the PAop streaming-bytes model (read ``x_e``,
  ``lam_w``, ``mu_w``; write ``y_e``; B/G tables and intermediates
  on-chip, paper Sec. 4.5) for every matrix-free level;
* ``oi_model`` = flops / bytes, the analytic operational intensity the
  measured point is placed against (``placement``, on the card's
  roofline at the peak of the measured dtype).

``fa`` has no per-element model: its row counts 2 FLOPs a nonzero and
the paper's CSR bytes (:meth:`~repro_torch.core.fa.SparseMatrix.memory_bytes`)
plus x read and y written once; it takes one scenario (an attribute
dict), as the ``fa`` level does.

Timing is device-fenced: every timed call ends in
:func:`repro_torch.device.synchronize`, so asynchronous launches cannot
leak compute into a later measurement (dispatch plus device compute,
never dispatch alone).  ``route`` says what ran: ``"cuda"`` when the
timed applies launched the PAop kernel, ``"plain"`` otherwise.  Beside
the reference's keys a row carries ``route``, ``device`` (the card's
name, or ``cpu``), ``memory_bytes`` (the stored operator,
:meth:`~repro_torch.core.operators.ElasticityOperator.memory_bytes`) and
``placement``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.flops import default_q1d, dense_flops_per_elem, paop_flops_per_elem
from repro_torch.core.operators import ElasticityOperator
from repro_torch.core.precision import resolve_precision
from repro_torch.device import resolve_device, synchronize
from repro_torch.fem.mesh import beam_hex
from repro_torch.fem.space import H1Space
from repro_torch.kernels.pa_elasticity import ops as _kops
from repro_torch.launch.roofline import H100_SXM, HardwareSpec, place_measured

__all__ = [
    "streaming_bytes_per_elem",
    "model_flops_per_elem",
    "operator_throughput",
]


def streaming_bytes_per_elem(p: int, itemsize: int, q1d: int | None = None) -> int:
    """PAop streaming-bytes model per element per apply: the 3-channel
    ``x_e`` read + ``y_e`` write (D^3 nodes) and the two weighted
    material fields (Q^3 points).  Basis tables and all intermediates
    are on-chip by construction (paper Sec. 4.5).  ``q1d`` defaults to
    :func:`repro_torch.core.flops.default_q1d`; pass the real quadrature
    count (``lam_w.shape[-1]``) when you have an operator in hand."""
    D = p + 1
    Q = default_q1d(p) if q1d is None else q1d
    return itemsize * (2 * 3 * D**3 + 2 * Q**3)


def model_flops_per_elem(p: int, assembly: str, q1d: int | None = None) -> float:
    """Analytic per-element FLOPs of one operator apply for the
    assembly family being measured (sum-factorized vs dense baseline)."""
    if assembly == "pa_baseline":
        return dense_flops_per_elem(p, q1d)
    return paop_flops_per_elem(p, q1d)


def _fenced_median_time(fn, x, *, device, warmup: int, repeats: int,
                        min_time_s: float, clock=time.perf_counter) -> float:
    """Median wall seconds per call, each call fenced with a device
    synchronize (dispatch + device compute, never dispatch alone)."""
    for _ in range(max(warmup, 1)):
        fn(x)
        synchronize(device)
    times = []
    for _ in range(max(repeats, 1)):
        n = 0
        t0 = clock()
        while True:
            fn(x)
            synchronize(device)
            n += 1
            dt = clock() - t0
            if dt >= min_time_s:
                break
        times.append(dt / n)
    times.sort()
    return times[len(times) // 2]


def _scenario_materials(n: int) -> list[dict]:
    """The beam benchmark's mixed material vocabulary (same family the
    serving benchmarks use), one dict per scenario row."""
    return [
        {1: (50.0 + 5.0 * (i % 3), 50.0), 2: (1.0 + 0.5 * (i % 2), 1.0)}
        for i in range(n)
    ]


def operator_throughput(
    p: int,
    refine: int,
    batch: int = 1,
    *,
    assembly: str = "paop_cuda",
    dtype: torch.dtype | None = None,
    precision: str | None = None,
    device=None,
    repeats: int = 3,
    min_time_s: float = 0.05,
    coarse_mesh=None,
    hw: HardwareSpec = H100_SXM,
    clock=time.perf_counter,
) -> dict[str, Any]:
    """Measure batched operator-apply throughput for one (p, refine,
    batch) cell; returns one row (a plain JSON-able dict).

    The operator is built like a solve level: S scenario material dicts
    folded to per-element fields on the fine mesh of ``coarse_mesh``
    (beam default) refined ``refine`` times, applied to a random
    (S, nscalar, 3) L-vector.

    ``precision`` names a :class:`~repro_torch.core.precision.PrecisionPolicy`;
    the operator is measured at the policy's ``precond_dtype`` (the dtype
    the V-cycle's element operator streams), and the row records
    ``precision_policy``.  ``device`` defaults to the card; the row names
    the device it ran on."""
    device = resolve_device(device)
    policy = resolve_precision(precision, dtype)
    dtype = policy.precond_dtype
    mesh = (coarse_mesh if coarse_mesh is not None else beam_hex()).refined(refine)
    space = H1Space(mesh, p)
    if assembly == "fa":
        if batch != 1:
            raise ValueError("assembly='fa' takes one scenario (batch=1)")
        materials = _scenario_materials(1)[0]
        shape = (space.nscalar, 3)
    else:
        materials = _scenario_materials(batch)
        shape = (batch, space.nscalar, 3)
    op = ElasticityOperator(
        space, assembly=assembly, materials=materials, dtype=dtype, device=device
    )
    gen = torch.Generator(device=device).manual_seed(p * 1000 + refine * 10 + batch)
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    launches = _kops.counts["pa_elasticity"].launches
    t = _fenced_median_time(
        op.apply, x, device=device, warmup=1, repeats=repeats,
        min_time_s=min_time_s, clock=clock,
    )
    route = "cuda" if _kops.counts["pa_elasticity"].launches > launches else "plain"

    itemsize = torch.empty((), dtype=dtype).element_size()
    nelem = space.nelem * batch  # folded scenario-element axis
    dofs = space.ndof * batch
    if assembly == "fa":
        bytes_per_apply = op.memory_bytes() + 2 * space.ndof * itemsize
        flops_per_apply = 2.0 * op._sparse.nnz
    else:
        # Real quadrature count off the bound material field.
        q1d = int(op.lam_w.shape[-1])
        bytes_per_apply = streaming_bytes_per_elem(p, itemsize, q1d) * nelem
        flops_per_apply = model_flops_per_elem(p, assembly, q1d) * nelem
    placed = place_measured(
        flops_per_apply=flops_per_apply, bytes_per_apply=bytes_per_apply,
        t_apply_s=t, hw=hw, dtype=dtype,
    )
    placement = dataclasses.asdict(placed)
    placement["hw"] = hw.name
    return {
        "p": int(p),
        "refine": int(refine),
        "batch": int(batch),
        "assembly": assembly,
        "route": route,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": str(dtype).removeprefix("torch."),
        "precision_policy": policy.name,
        "ndof": int(space.ndof),
        "nelem": int(space.nelem),
        "dofs": int(dofs),
        "t_apply_s": float(t),
        "dofs_per_s": float(dofs / t),
        "gdofs_per_s": float(dofs / t / 1e9),
        "bytes_per_apply": int(bytes_per_apply),
        "gbytes_per_s": float(bytes_per_apply / t / 1e9),
        "flops_per_apply": float(flops_per_apply),
        "gflops_per_s": float(flops_per_apply / t / 1e9),
        "oi_model": float(flops_per_apply / bytes_per_apply),
        "memory_bytes": int(op.memory_bytes()),
        "placement": placement,
    }
