"""Public wrapper of the flash-attention kernel.

:func:`flash_attention` checks device, dtype, shape and strides, then:

* for CUDA tensors launches the hand-written kernel (built from ``csrc/``
  at first use, see :mod:`.build`) or raises; there is no fallback, and
  unlike the reference's wrapper no detour to the plain version for short
  sequences: the kernel takes any S >= 1;
* for CPU tensors runs its plain PyTorch version :func:`.ref.flash_ref`.

Block sizes are the kernel's own compile-time constants; the reference's
``pick_block`` and its ``S % block == 0`` requirement are TPU tiling and
have no counterpart.  ``counts["flash_attention"]`` keeps ``launches`` and
``plain_calls``; :func:`reset_counts` zeroes them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import flash_ref

__all__ = [
    "flash_attention",
    "counts",
    "reset_counts",
    "SUPPORTED_D",
    "KERNEL_DTYPES",
]

SUPPORTED_D = (8, 16, 32, 64, 128)
KERNEL_DTYPES = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0


counts = {"flash_attention": Counts()}


def reset_counts() -> None:
    for c in counts.values():
        c.launches = c.plain_calls = 0


def _check_args(q, k, v, window) -> tuple[int, int, int, int, int]:
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} is {t.dtype} on {t.device}, expected "
                f"{q.dtype} on {q.device} like q"
            )
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, got {tuple(t.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous in its last dimension")
    B, S, H, D = q.shape
    K = k.shape[2]
    if tuple(k.shape) != (B, S, K, D) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} must both "
            f"be (B, S, K, D) = ({B}, {S}, K, {D}) for q {tuple(q.shape)}"
        )
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: H = {H} query heads is not a multiple of K = {K}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"flash_attention: no kernel instantiation for dtype {q.dtype}; "
            f"instantiated for float32 and bfloat16"
        )
    if D not in SUPPORTED_D:
        raise ValueError(
            f"flash_attention: no kernel instantiation for head dim D = {D}; "
            f"instantiated for D in {SUPPORTED_D}"
        )
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"flash_attention: window must be None or an int >= 1, got {window!r}")
    return B, S, H, K, D


def flash_attention(q, k, v, *, window=None):
    """Causal GQA attention. q (B, S, H, D); k/v (B, S, K, D), H = K * G,
    query head h = k * G + g.  Optional sliding window: position s sees
    t with s - window < t <= s.  Returns (B, S, H, D) in q.dtype."""
    B, S, H, K, D = _check_args(q, k, v, window)
    if q.device.type == "cpu":
        counts["flash_attention"].plain_calls += 1
        return flash_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    kl = build.load()
    fn = getattr(kl.lib, KERNEL_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, K, D, window or 0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            stream,
        )
    kl.check(err, f"flash_attention launch (B={B}, S={S}, H={H}, K={K}, D={D}, {q.dtype})")
    counts["flash_attention"].launches += 1
    return o
