"""Public wrappers of the PAop kernel and the probe kernel, and of the
first port's PAop kernel kept as a yardstick (:func:`launch_baseline`).

Each wrapper checks device, dtype, shape and contiguity, then:

* for CUDA tensors launches its hand-written kernel (built from
  ``csrc/`` at first use, see :mod:`.build`) or raises — there is no
  fallback;
* for CPU tensors runs its plain PyTorch version from :mod:`.ref`.

``counts[name]`` keeps plain integers per kernel, ``launches`` and
``plain_calls`` (and, for PAop, ``dtype_launches``: the launches by the
dtype of x_e), so a run can show that its path went through the kernels;
:func:`reset_counts` zeroes them.

On the meta device (the dry-run's stand-ins) :func:`pa_elasticity` returns
an empty y_e, counts ``meta_calls`` (never ``launches`` or
``plain_calls``) and reports the kernel's analytic work to
:func:`repro_torch.kernels._meta.charge`: ``paop_flops_per_elem(p)`` x NE
FLOPs, every input read and y_e written once.  Only a meta tensor takes that path.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flops import default_q1d, paop_flops_per_elem
from repro_torch.kernels._meta import charge
from repro_torch.kernels.pa_elasticity import build
from repro_torch.kernels.pa_elasticity.ref import paop_ref, probe_ref

__all__ = [
    "pa_elasticity",
    "launch_baseline",
    "probe",
    "check_probe",
    "counts",
    "reset_counts",
    "SUPPORTED_P",
    "KERNEL_DTYPES",
    "TABLE_DTYPE",
]

SUPPORTED_P = tuple(range(1, 9))
KERNEL_DTYPES = (torch.float64, torch.float32, torch.bfloat16)
# The dtype of J^{-1}, B and G for an x_e/lam_w/mu_w dtype: the compute
# dtype.  The bfloat16 kernel reads its tables in float32 (read once a block;
# rounded to bfloat16, G's rows no longer sum to zero).
TABLE_DTYPE = {torch.float64: torch.float64, torch.float32: torch.float32,
               torch.bfloat16: torch.float32}


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0
    meta_calls: int = 0
    dtype_launches: dict = dataclasses.field(default_factory=dict)


counts = {"pa_elasticity": Counts(), "probe": Counts()}


def reset_counts() -> None:
    for c in counts.values():
        c.launches = c.plain_calls = c.meta_calls = 0
        c.dtype_launches.clear()


_PA_NAMES = ("x_e", "lam_w", "mu_w", "jinv", "B", "G")


def _check_pa_args(x_e, lam_w, mu_w, jinv, B, G) -> tuple[int, int, int]:
    if jinv.ndim != 2:
        raise ValueError(
            "pa_elasticity kernel assumes a mesh-constant affine J^{-1}; "
            "use repro_torch.core.paop.paop_apply for per-element geometry"
        )
    dtype, index = x_e.dtype, x_e.get_device()  # -1 off the card
    if dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"pa_elasticity: no kernel instantiation for dtype {dtype}; "
            f"instantiated for float64, float32 and bfloat16"
        )
    for name, t in zip(_PA_NAMES, (x_e, lam_w, mu_w, jinv, B, G)):
        want = dtype if name in ("x_e", "lam_w", "mu_w") else TABLE_DTYPE[dtype]
        if t.dtype != want or t.get_device() != index or (
            index < 0 and t.device != x_e.device
        ):
            raise ValueError(
                f"pa_elasticity: {name} is {t.dtype} on {t.device}, expected "
                f"{want} on {x_e.device} (x_e is {dtype})"
            )
        if not t.is_contiguous():
            raise ValueError(f"pa_elasticity: {name} must be contiguous")
    shape = x_e.shape
    if len(shape) != 5 or shape[1] != 3 or not shape[2] == shape[3] == shape[4]:
        raise ValueError(
            f"pa_elasticity: x_e has shape {tuple(shape)}, expected "
            f"(nelem, 3, D1D, D1D, D1D)"
        )
    ne, d1d, q1d = shape[0], shape[4], lam_w.shape[-1]
    if lam_w.shape != (ne, q1d, q1d, q1d) or mu_w.shape != lam_w.shape:
        raise ValueError(
            f"pa_elasticity: lam_w {tuple(lam_w.shape)} / mu_w "
            f"{tuple(mu_w.shape)} must both be (nelem, Q1D, Q1D, Q1D) with "
            f"nelem={ne}"
        )
    if B.shape != (q1d, d1d) or B.shape != G.shape or jinv.shape != (3, 3):
        raise ValueError(
            f"pa_elasticity: B {tuple(B.shape)}, G {tuple(G.shape)} must be "
            f"(Q1D, D1D) = ({q1d}, {d1d}) and jinv {tuple(jinv.shape)} (3, 3)"
        )
    p = d1d - 1
    if p not in SUPPORTED_P or q1d != default_q1d(p):
        raise ValueError(
            f"pa_elasticity: no kernel instantiation for (D1D, Q1D) = "
            f"({d1d}, {q1d}); instantiated for p = 1..8 with Q1D = p + 2"
        )
    return ne, d1d, q1d


def _on_stream(fn, t, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` on the current stream of
    ``t``'s card.  The device context is entered only when that card is not
    the current one.  The stream is PyTorch's current one, read as a raw
    handle: ``torch.cuda.current_stream()`` builds a ``Stream`` object,
    several microseconds of host time a call."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _launch(name, x_e, lam_w, mu_w, jinv, B, G):
    """Launch the library's entry ``name`` ("pa_elasticity" or
    "pa_elasticity_baseline") on checked CUDA tensors; returns y_e."""
    ne, d1d, q1d = x_e.shape[0], x_e.shape[4], lam_w.shape[-1]
    y = torch.empty_like(x_e)
    if ne == 0:
        return y
    kl = build.load()
    err = _on_stream(
        getattr(kl, name)[x_e.dtype], x_e,
        x_e.data_ptr(), lam_w.data_ptr(), mu_w.data_ptr(), jinv.data_ptr(),
        B.data_ptr(), G.data_ptr(), y.data_ptr(), ne, d1d, q1d,
    )
    if err:
        kl.check(err, f"{name} launch (D1D={d1d}, Q1D={q1d}, {x_e.dtype})")
    return y


def pa_elasticity(x_e, lam_w, mu_w, jinv, B, G):
    """Fused PAop operator action.

    x_e:    (nelem, 3, D1D, D1D, D1D)
    lam_w:  (nelem, Q1D, Q1D, Q1D)     (mu_w likewise)
    jinv:   (3, 3) mesh-constant affine J^{-1}
    B, G:   (Q1D, D1D)
    Returns y_e in the layout and dtype of x_e.  x_e, lam_w and mu_w are
    float64, float32 or bfloat16; the tables are in :data:`TABLE_DTYPE`
    of that (float32 for bfloat16, whose apply computes in float32 and
    rounds y_e once).
    """
    ne, d1d, _ = _check_pa_args(x_e, lam_w, mu_w, jinv, B, G)
    if x_e.device.type == "meta":
        counts["pa_elasticity"].meta_calls += 1
        y = torch.empty_like(x_e)
        charge(paop_flops_per_elem(d1d - 1) * ne,
               sum(t.numel() * t.element_size() for t in (x_e, lam_w, mu_w, jinv, B, G, y)))
        return y
    if not x_e.is_cuda:
        if x_e.device.type != "cpu":
            raise ValueError(f"pa_elasticity: unsupported device {x_e.device}")
        counts["pa_elasticity"].plain_calls += 1
        return paop_ref(x_e, lam_w, mu_w, jinv, B, G)
    y = _launch("pa_elasticity", x_e, lam_w, mu_w, jinv, B, G)
    if ne:
        c = counts["pa_elasticity"]
        c.launches += 1
        c.dtype_launches[x_e.dtype] = c.dtype_launches.get(x_e.dtype, 0) + 1
    return y


def launch_baseline(x_e, lam_w, mu_w, jinv, B, G):
    """The first port's PAop kernel (``csrc/pa_elasticity_baseline.cu``) on
    CUDA tensors, as a yardstick for :func:`pa_elasticity`'s kernel: timed
    beside it by ``chip_smoke.py`` and held against the plain version by the
    card's tests.  The main path never routes here, and it is not counted.
    Raises for a tensor on any other device."""
    _check_pa_args(x_e, lam_w, mu_w, jinv, B, G)
    if not x_e.is_cuda:
        raise ValueError(
            f"pa_elasticity baseline: runs only on CUDA tensors, got {x_e.device}"
        )
    if x_e.dtype == torch.bfloat16:
        raise ValueError("pa_elasticity baseline: instantiated for float64 and float32")
    return _launch("pa_elasticity_baseline", x_e, lam_w, mu_w, jinv, B, G)


def probe(x):
    """``o = 2 x`` on a contiguous float32 tensor."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe: x must be a contiguous float32 tensor")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"probe: unsupported device {x.device}")
        counts["probe"].plain_calls += 1
        return probe_ref(x)
    kl = build.load()
    o = torch.empty_like(x)
    err = _on_stream(kl.probe, x, x.data_ptr(), o.data_ptr(), x.numel())
    if err:
        kl.check(err, "probe kernel launch")
    counts["probe"].launches += 1
    return o


def check_probe(device) -> None:
    """Run the probe on ``device`` at its (8, 128) shape and compare it with
    ``2 x``; raises on a wrong result.  The counterpart of the reference's
    capability probe, run where the reference resolves its lane: at every
    operator construction."""
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128)
    if not torch.equal(probe(x), probe_ref(x)):
        raise RuntimeError(f"probe kernel returned a wrong result on {device}")
