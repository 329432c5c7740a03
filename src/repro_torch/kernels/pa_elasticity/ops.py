"""Public wrappers of the PAop kernel and the probe kernel.

Each wrapper checks device, dtype, shape and contiguity, then:

* for CUDA tensors launches its hand-written kernel (built from
  ``csrc/`` at first use, see :mod:`.build`) or raises — there is no
  fallback;
* for CPU tensors runs its plain PyTorch version from :mod:`.ref`.

``counts[name]`` keeps two plain integers per kernel, ``launches`` and
``plain_calls``, so a run can show that its path went through the
kernels; :func:`reset_counts` zeroes them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flops import default_q1d
from repro_torch.kernels.pa_elasticity import build
from repro_torch.kernels.pa_elasticity.ref import paop_ref, probe_ref

__all__ = [
    "pa_elasticity",
    "probe",
    "check_probe",
    "counts",
    "reset_counts",
    "SUPPORTED_P",
    "KERNEL_DTYPES",
]

SUPPORTED_P = tuple(range(1, 9))
KERNEL_DTYPES = {torch.float64: "pa_elasticity_f64", torch.float32: "pa_elasticity_f32"}


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0


counts = {"pa_elasticity": Counts(), "probe": Counts()}


def reset_counts() -> None:
    for c in counts.values():
        c.launches = c.plain_calls = 0


def _check_pa_args(x_e, lam_w, mu_w, jinv, B, G) -> tuple[int, int, int]:
    if jinv.ndim != 2:
        raise ValueError(
            "pa_elasticity kernel assumes a mesh-constant affine J^{-1}; "
            "use repro_torch.core.paop.paop_apply for per-element geometry"
        )
    args = {"x_e": x_e, "lam_w": lam_w, "mu_w": mu_w, "jinv": jinv, "B": B, "G": G}
    for name, t in args.items():
        if t.dtype != x_e.dtype or t.device != x_e.device:
            raise ValueError(
                f"pa_elasticity: {name} is {t.dtype} on {t.device}, expected "
                f"{x_e.dtype} on {x_e.device} like x_e"
            )
        if not t.is_contiguous():
            raise ValueError(f"pa_elasticity: {name} must be contiguous")
    if x_e.ndim != 5 or x_e.shape[1] != 3 or len(set(x_e.shape[2:])) != 1:
        raise ValueError(
            f"pa_elasticity: x_e has shape {tuple(x_e.shape)}, expected "
            f"(nelem, 3, D1D, D1D, D1D)"
        )
    ne, d1d, q1d = x_e.shape[0], x_e.shape[-1], lam_w.shape[-1]
    if tuple(lam_w.shape) != (ne, q1d, q1d, q1d) or mu_w.shape != lam_w.shape:
        raise ValueError(
            f"pa_elasticity: lam_w {tuple(lam_w.shape)} / mu_w "
            f"{tuple(mu_w.shape)} must both be (nelem, Q1D, Q1D, Q1D) with "
            f"nelem={ne}"
        )
    if tuple(B.shape) != (q1d, d1d) or B.shape != G.shape or tuple(jinv.shape) != (3, 3):
        raise ValueError(
            f"pa_elasticity: B {tuple(B.shape)}, G {tuple(G.shape)} must be "
            f"(Q1D, D1D) = ({q1d}, {d1d}) and jinv {tuple(jinv.shape)} (3, 3)"
        )
    if x_e.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"pa_elasticity: no kernel instantiation for dtype {x_e.dtype}; "
            f"instantiated for float64 and float32"
        )
    p = d1d - 1
    if p not in SUPPORTED_P or q1d != default_q1d(p):
        raise ValueError(
            f"pa_elasticity: no kernel instantiation for (D1D, Q1D) = "
            f"({d1d}, {q1d}); instantiated for p = 1..8 with Q1D = p + 2"
        )
    return ne, d1d, q1d


def pa_elasticity(x_e, lam_w, mu_w, jinv, B, G):
    """Fused PAop operator action.

    x_e:    (nelem, 3, D1D, D1D, D1D)
    lam_w:  (nelem, Q1D, Q1D, Q1D)     (mu_w likewise)
    jinv:   (3, 3) mesh-constant affine J^{-1}
    B, G:   (Q1D, D1D)
    Returns y_e in the layout of x_e.
    """
    ne, d1d, q1d = _check_pa_args(x_e, lam_w, mu_w, jinv, B, G)
    if x_e.device.type == "cpu":
        counts["pa_elasticity"].plain_calls += 1
        return paop_ref(x_e, lam_w, mu_w, jinv, B, G)
    if x_e.device.type != "cuda":
        raise ValueError(f"pa_elasticity: unsupported device {x_e.device}")
    y = torch.empty_like(x_e)
    if ne == 0:
        return y
    kl = build.load()
    fn = getattr(kl.lib, KERNEL_DTYPES[x_e.dtype])
    with torch.cuda.device(x_e.device):
        stream = torch.cuda.current_stream(x_e.device).cuda_stream
        err = fn(
            x_e.data_ptr(), lam_w.data_ptr(), mu_w.data_ptr(), jinv.data_ptr(),
            B.data_ptr(), G.data_ptr(), y.data_ptr(), ne, d1d, q1d, stream,
        )
    kl.check(err, f"pa_elasticity launch (D1D={d1d}, Q1D={q1d}, {x_e.dtype})")
    counts["pa_elasticity"].launches += 1
    return y


def probe(x):
    """``o = 2 x`` on a contiguous float32 tensor."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe: x must be a contiguous float32 tensor")
    if x.device.type == "cpu":
        counts["probe"].plain_calls += 1
        return probe_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {x.device}")
    kl = build.load()
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kl.lib.probe_f32(x.data_ptr(), o.data_ptr(), x.numel(), stream)
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
