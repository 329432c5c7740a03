"""Public wrapper of the flash-attention kernel.

:func:`flash_attention` checks device, dtype, shape and strides, then:

* for CUDA tensors launches one of three hand-written kernels (built from
  ``csrc/`` at first use, see :mod:`.build`) or raises; there is no
  fallback, and unlike the reference's wrapper no detour to the plain
  version for short sequences: every kernel takes any S >= 1;
* for CPU tensors runs its plain PyTorch version :func:`.ref.flash_ref`.

Which kernel runs is :func:`route`'s answer, from dtype, head dim,
pointer alignment and strides alone (never from a failed launch):

* ``"wgmma"``: bf16, D in {64, 128}, every base pointer and (b, s, h)
  stride 16-byte aligned: TMA loads, wgmma products, a warp-specialised
  pipeline (``csrc/flash_attention_wgmma.cu``);
* ``"mma_sync"``: other bf16 with D >= 16: ``mma.sync`` tensor-core kernel
  (``csrc/flash_attention.cu``);
* ``"fma"``: float32, and bf16 at D = 8: the FMA-unit kernel (same file).

Block sizes are the kernels' own compile-time constants; the reference's
``pick_block`` and its ``S % block == 0`` requirement are TPU tiling and
have no counterpart.  ``counts["flash_attention"]`` keeps ``launches`` and
``plain_calls``; ``route_launches`` counts the launches of each route
beside it; :func:`reset_counts` zeroes both.

The gradient: :func:`flash_attention_bwd` launches the backward kernel
(``csrc/flash_attention_bwd.cu``, bf16 and float32, D in
:data:`BWD_D`) for CUDA tensors or raises, and runs its plain version
:func:`.ref.flash_bwd_ref` for CPU tensors; ``counts["flash_attention_bwd"]``
counts it.  :class:`FlashAttention` is the ``torch.autograd.Function``
that joins the two; :func:`flash_attention` enters it only when grad mode
is on and an input requires grad, so inference (the serve path) never
saves anything for a backward.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_ref

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "call_bwd",
    "FlashAttention",
    "launch",
    "route",
    "counts",
    "route_launches",
    "reset_counts",
    "ROUTES",
    "SUPPORTED_D",
    "BWD_D",
    "KERNEL_DTYPES",
]

SUPPORTED_D = (8, 16, 32, 64, 128)
BWD_D = (16, 32, 64, 128)  # the backward kernel's instantiations
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
ROUTES = ("wgmma", "mma_sync", "fma")
WGMMA_D = (64, 128)


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0


counts = {"flash_attention": Counts(), "flash_attention_bwd": Counts()}
route_launches = dict.fromkeys(ROUTES, 0)


def reset_counts() -> None:
    for c in counts.values():
        c.launches = c.plain_calls = 0
    for r in ROUTES:
        route_launches[r] = 0


def _aligned16(t: torch.Tensor) -> bool:
    """Base pointer and the strides of every dimension of more than one
    element but the last on 16-byte boundaries (the wgmma kernel's TMA
    maps); a size-1 dimension is never stepped over."""
    size = t.element_size()
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or (st > 0 and st * size % 16 == 0)
               for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def route(q, k, v) -> str:
    """The kernel that :func:`flash_attention` launches for these (checked)
    CUDA or CPU tensors: one of :data:`ROUTES`, from shape, dtype and
    layout alone."""
    D = q.shape[-1]
    if q.dtype == torch.float32 or D < 16:
        return "fma"
    if D in WGMMA_D and all(_aligned16(t) for t in (q, k, v)):
        return "wgmma"
    return "mma_sync"


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
    t with s - window < t <= s.  Returns (B, S, H, D) in q.dtype.

    Differentiable: with grad mode on and an input that requires grad it
    goes through :class:`FlashAttention`, whose backward is
    :func:`flash_attention_bwd`."""
    _check_args(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, window)
    return _forward(q, k, v, window)


def _forward(q, k, v, window):
    if q.device.type == "cpu":
        counts["flash_attention"].plain_calls += 1
        return flash_ref(q, k, v, window=window)
    return launch(route(q, k, v), q, k, v, window=window)


def launch(name: str, q, k, v, *, window=None):
    """Launch the kernel of route ``name`` on CUDA tensors and count it.
    :func:`flash_attention` passes :func:`route`'s answer; a caller may name
    another route that takes these inputs (``"mma_sync"`` takes every bf16
    input with D >= 16, ``"fma"`` every input) to time it beside the first.
    Raises if the kernel refuses them."""
    B, S, H, K, D = _check_args(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    entry = build.ENTRY_POINTS.get((name, KERNEL_DTYPES[q.dtype])) if name in ROUTES else None
    if entry is None:
        raise ValueError(f"flash_attention: no {name!r} kernel for {q.dtype}")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    kl = build.load()
    fn = getattr(kl.lib, entry)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, K, D, window or 0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            stream,
        )
    kl.check(err, f"flash_attention {name} launch (B={B}, S={S}, H={H}, K={K}, D={D}, {q.dtype})")
    counts["flash_attention"].launches += 1
    route_launches[name] += 1
    return o


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward is
    :func:`flash_attention`'s (the kernel on the card, the plain version on
    the CPU) and saves q, k, v and o; the backward is
    :func:`flash_attention_bwd`.  There is no fallback: a backward kernel
    that fails to build or launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o = _forward(q, k, v, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, window=ctx.window)
        return dq, dk, dv, None


def flash_attention_bwd(q, k, v, o, do, *, window=None):
    """Gradient of :func:`flash_attention`: given q (B, S, H, D), k/v
    (B, S, K, D), the forward's output o and the output gradient do (both
    (B, S, H, D)), returns (dq, dk, dv) in the input dtype, accumulated in
    f32, scale 1/sqrt(D) as in the forward.

    CUDA tensors launch the backward kernel or raise; CPU tensors run
    :func:`.ref.flash_bwd_ref`.  One call is one launch in
    ``counts["flash_attention_bwd"]``; it runs three kernels of
    ``csrc/flash_attention_bwd.cu`` in turn: ``bwd_prep`` (LSE and delta per
    query row), ``bwd_dkdv`` (dk, dv per key tile), ``bwd_dq`` (dq per query
    tile)."""
    B, S, H, K, D = _check_args(q, k, v, window)
    for name, t in {"o": o, "do": do}.items():
        if t.dtype != q.dtype or t.device != q.device or t.shape != q.shape:
            raise ValueError(
                f"flash_attention_bwd: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"expected {tuple(q.shape)} {q.dtype} on {q.device} like q"
            )
    if D not in BWD_D:
        raise ValueError(
            f"flash_attention_bwd: no kernel instantiation for head dim D = {D}; "
            f"instantiated for D in {BWD_D} in float32 and bfloat16"
        )
    if q.device.type == "cpu":
        counts["flash_attention_bwd"].plain_calls += 1
        return flash_bwd_ref(q, k, v, o, do, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # The kernels copy 16-byte rows asynchronously: an input whose base or
    # (b, s, h) strides are not 16-byte multiples (a strided view) is copied
    # to a fresh contiguous tensor first.
    ins = [t if t.data_ptr() % 16 == 0 and t.stride(-1) == 1
           and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
           else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v, o, do)]
    kl = build.load()
    err, grads = call_bwd(getattr(kl.lib, build.ENTRY_POINTS[("bwd", KERNEL_DTYPES[q.dtype])]),
                          *ins, window=window)
    kl.check(err, f"flash_attention_bwd launch (B={B}, S={S}, H={H}, K={K}, D={D}, {q.dtype})")
    counts["flash_attention_bwd"].launches += 1
    return grads


def call_bwd(fn, q, k, v, o, do, *, window=None) -> tuple[int, tuple]:
    """Call the backward entry point ``fn`` of a built flash library (this
    checkout's, or another build's in :mod:`.compare`) on non-empty CUDA
    tensors whose rows are 16-byte aligned; returns its error code and
    (dq, dk, dv).  Not counted: :func:`flash_attention_bwd` counts."""
    B, S, H, D = q.shape
    K = k.shape[2]
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, K, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ts = (q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in ts), lse.data_ptr(), delta.data_ptr(),
            B, S, H, K, D, window or 0, *(st for t in ts for st in t.stride()[:3]), stream,
        )
    return err, (dq, dk, dv)
