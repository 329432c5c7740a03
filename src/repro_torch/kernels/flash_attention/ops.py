"""Public wrapper of the flash-attention kernel.

:func:`flash_attention` checks device, dtype, shape and strides, then:

* for CUDA tensors launches one of three hand-written kernels (built from
  ``csrc/`` at first use, see :mod:`.build`) or raises; there is no
  fallback, and unlike the reference's wrapper no detour to the plain
  version for short sequences: every kernel takes any S >= 1;
* for CPU tensors runs its plain PyTorch version :func:`.ref.flash_ref`.

Which kernel runs is :func:`route`'s answer, from dtype, head dim,
pointer alignment and strides alone (never from a failed launch):

* ``"wgmma"``: bf16, D in :data:`WGMMA_D` = {64, 80, 128} (80 is
  zamba2-2.7b's head dim), every base pointer and (b, s, h) stride 16-byte
  aligned: TMA loads, wgmma products, a warp-specialised pipeline
  (``csrc/flash_attention_wgmma.cu``);
* ``"mma_sync"``: other bf16 with D >= 16 (D in {16, 32}, and 64, 80 or 128
  with unaligned rows): ``mma.sync`` tensor-core kernel
  (``csrc/flash_attention.cu``);
* ``"fma"``: float32, and bf16 at D = 8: the FMA-unit kernel (same file),
  D in :data:`FMA_D`.  It has no D = 80 tiling: float32 at D = 80 raises
  on the card, naming the routes that take D = 80 (bf16 on wgmma and
  mma_sync), and never switches to another route.

Block sizes are the kernels' own compile-time constants; the reference's
``pick_block`` and its ``S % block == 0`` requirement are TPU tiling and
have no counterpart.  ``counts["flash_attention"]`` keeps ``launches`` and
``plain_calls``; ``route_launches`` counts the launches of each route
beside it; :func:`reset_counts` zeroes both.

On the meta device (the dry-run's stand-ins) both directions return empty
results of the right shapes and dtypes, count ``meta_calls`` (never
``launches`` or ``plain_calls``), and report the kernel's own analytic
work, :func:`work`, to :func:`repro_torch.kernels._meta.charge`: 4 D FLOPs a scored (query, key) pair of each
head, 2.5x that backward.  Only a meta tensor takes this path.

With ``lse=True`` a forward also returns each row's log-sum-exp (f32
(B, H, S), natural log; :func:`.ref.flash_lse` on the CPU): every route's
kernel writes it beside o.  The serve path never asks for it.

The gradient: :func:`flash_attention_bwd` takes the forward's LSE and, for
CUDA tensors, launches the backward route :func:`bwd_route` picks, from
dtype and head dim alone, or raises:

* ``"wgmma"``: bf16, D in :data:`WGMMA_D` = {64, 80, 128}
  (``csrc/flash_attention_bwd_wgmma.cu``: TMA, wgmma, a persistent
  warp-specialised pipeline);
* ``"mma_sync"``: other bf16 with D in :data:`BWD_D` (16 and 32)
  (``csrc/flash_attention_bwd.cu``; a caller may name it at any D in
  :data:`BWD_D`);
* ``"fma"``: float32 (same file), D in :data:`FMA_D` but 8; float32 at
  D = 80 raises, as in the forward.

An input whose base or strides are off 16 bytes is copied to a contiguous
tensor before any route, so alignment picks none.  Each call first runs the
delta pass.  CPU tensors run
:func:`.ref.flash_bwd_ref`, which needs no LSE.
``counts["flash_attention_bwd"]`` counts calls and ``bwd_route_launches``
each route's.  :class:`FlashAttention` is the ``torch.autograd.Function``
that joins the two; :func:`flash_attention` enters it only when grad mode
is on and an input requires grad, so inference (the serve path) never
saves anything for a backward.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels._meta import charge
from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_lse, flash_ref

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "call_bwd",
    "FlashAttention",
    "launch",
    "launch_bwd",
    "route",
    "bwd_route",
    "counts",
    "route_launches",
    "bwd_route_launches",
    "reset_counts",
    "ROUTES",
    "BWD_ROUTES",
    "SUPPORTED_D",
    "FMA_D",
    "BWD_D",
    "WGMMA_D",
    "KERNEL_DTYPES",
    "band_pairs",
    "work",
]

SUPPORTED_D = (8, 16, 32, 64, 80, 128)
FMA_D = (8, 16, 32, 64, 128)  # the FMA kernels' instantiations (f32; bf16 at D = 8)
BWD_D = (16, 32, 64, 80, 128)  # the backward kernels' instantiations
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
ROUTES = ("wgmma", "mma_sync", "fma")
BWD_ROUTES = ROUTES  # the backward's routes have the forward's names
WGMMA_D = (64, 80, 128)  # the wgmma kernels' instantiations (both directions)


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0
    meta_calls: int = 0


counts = {"flash_attention": Counts(), "flash_attention_bwd": Counts()}
route_launches = dict.fromkeys(ROUTES, 0)
bwd_route_launches = dict.fromkeys(BWD_ROUTES, 0)


def reset_counts() -> None:
    for c in counts.values():
        c.launches = c.plain_calls = c.meta_calls = 0
    for r in ROUTES:
        route_launches[r] = 0
    for r in BWD_ROUTES:
        bwd_route_launches[r] = 0


def _aligned16(t: torch.Tensor) -> bool:
    """Base pointer and the strides of every dimension of more than one
    element but the last on 16-byte boundaries (the wgmma kernel's TMA
    maps); a size-1 dimension is never stepped over."""
    size = t.element_size()
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or (st > 0 and st * size % 16 == 0)
               for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _route(q, aligned: bool) -> str:
    D = q.shape[-1]
    if q.dtype == torch.float32 or D < 16:
        return "fma"
    return "wgmma" if D in WGMMA_D and aligned else "mma_sync"


def route(q, k, v) -> str:
    """The kernel that :func:`flash_attention` launches for these (checked)
    CUDA or CPU tensors: one of :data:`ROUTES`, from shape, dtype and
    layout alone.  The forward reads its inputs in place, so the wgmma
    route's TMA maps need q, k, v 16-byte aligned."""
    return _route(q, all(_aligned16(t) for t in (q, k, v)))


def bwd_route(q, k, v) -> str:
    """The backward kernel that :func:`flash_attention_bwd` launches for
    these (checked) tensors: one of :data:`BWD_ROUTES`, from dtype and head
    dim alone (D in :data:`BWD_D`).  :func:`launch_bwd` copies an input
    that is not 16-byte aligned first, so every layout may take wgmma."""
    return _route(q, True)


def _check_fma(name: str, D: int, what: str) -> None:
    """Refuse the fma route at a head dim it has no tiling for (D = 80),
    naming the routes that take it."""
    if name == "fma" and D not in FMA_D:
        raise ValueError(
            f"{what}: the fma route (float32) has no instantiation for head dim D = {D} "
            f"(it takes D in {FMA_D}); D = {D} is instantiated for bfloat16 on the wgmma and "
            f"mma_sync routes only")


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


def band_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal call scores: S(S+1)/2, or under a window
    W each query's min(i + 1, W) keys."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def work(q, k, window=None, backward: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: 4 B H D x the band's pairs forward (2.5x
    that backward); q, k, v read and o written once (backward: q, k, v, o
    and dO read, dq, dk and dv written)."""
    B, S, H, D = q.shape
    flops = 4.0 * B * H * D * band_pairs(S, window)
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    if backward:
        return 2.5 * flops, 4 * qb + 4 * kb
    return flops, 2 * qb + 2 * kb


def _meta_call(name: str, q, k, window, backward: bool) -> None:
    counts[name].meta_calls += 1
    charge(*work(q, k, window, backward))


def _forward(q, k, v, window, lse=False):
    if q.device.type == "meta":
        _meta_call("flash_attention", q, k, window, backward=False)
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        if lse:
            B, S, H, _ = q.shape
            return o, torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        return o
    if q.device.type == "cpu":
        counts["flash_attention"].plain_calls += 1
        o = flash_ref(q, k, v, window=window)
        return (o, flash_lse(q, k, window=window)) if lse else o
    return launch(route(q, k, v), q, k, v, window=window, lse=lse)


def launch(name: str, q, k, v, *, window=None, lse=False):
    """Launch the kernel of route ``name`` on CUDA tensors and count it.
    :func:`flash_attention` passes :func:`route`'s answer; a caller may name
    another route that takes these inputs (``"mma_sync"`` takes every bf16
    input with D >= 16, ``"fma"`` every input) to time it beside the first.
    With ``lse`` returns (o, the f32 (B, H, S) LSE).  Raises if the kernel
    refuses them."""
    B, S, H, K, D = _check_args(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_fma(name, D, "flash_attention")
    table = build.LSE_ENTRY_POINTS if lse else build.ENTRY_POINTS
    entry = table.get((name, KERNEL_DTYPES[q.dtype])) if name in ROUTES else None
    if entry is None:
        raise ValueError(f"flash_attention: no {name!r} kernel for {q.dtype}")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse_t = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if lse else None
    if o.numel() == 0:
        return (o, lse_t) if lse else o
    kl = build.load()
    fn = getattr(kl.lib, entry)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, K, D, window or 0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *((lse_t.data_ptr(),) if lse else ()), stream,
        )
    kl.check(err, f"flash_attention {name} launch (B={B}, S={S}, H={H}, K={K}, D={D}, {q.dtype})")
    counts["flash_attention"].launches += 1
    route_launches[name] += 1
    return (o, lse_t) if lse else o


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward is
    :func:`flash_attention`'s (the kernel on the card, the plain version on
    the CPU) and saves q, k, v, o and the LSE it writes beside o; the
    backward is :func:`flash_attention_bwd`.  Under remat the forward runs
    again in the recompute, and that run's LSE is the one saved.  There is
    no fallback: a backward kernel that fails to build or launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = _forward(q, k, v, window, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse=lse, window=ctx.window)
        return dq, dk, dv, None


def flash_attention_bwd(q, k, v, o, do, *, lse=None, window=None):
    """Gradient of :func:`flash_attention`: given q (B, S, H, D), k/v
    (B, S, K, D), the forward's output o, the output gradient do (both
    (B, S, H, D)) and the forward's LSE (f32 (B, H, S), natural log),
    returns (dq, dk, dv) in the input dtype, accumulated in f32, scale
    1/sqrt(D) as in the forward.

    CUDA tensors launch the route of :func:`bwd_route` or raise (a missing
    ``lse`` too); CPU tensors run :func:`.ref.flash_bwd_ref`, which needs no
    LSE.  One call is one launch in ``counts["flash_attention_bwd"]``."""
    dims = _check_bwd_args(q, k, v, o, do, window)
    if q.device.type == "meta":
        _meta_call("flash_attention_bwd", q, k, window, backward=True)
        return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                     for t in (q, k, v))
    if q.device.type == "cpu":
        counts["flash_attention_bwd"].plain_calls += 1
        return flash_bwd_ref(q, k, v, o, do, window=window)
    return _launch_bwd(bwd_route(q, k, v), dims, q, k, v, o, do, lse, window)


def _check_bwd_args(q, k, v, o, do, window) -> tuple[int, int, int, int, int]:
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
    return B, S, H, K, D


def launch_bwd(name: str, q, k, v, o, do, lse, *, window=None):
    """Launch the backward route ``name`` on CUDA tensors and count it.
    :func:`flash_attention_bwd` launches :func:`bwd_route`'s answer; a
    caller may name ``"mma_sync"`` for bf16 inputs the wgmma route takes,
    to time it beside the first.  Raises if the route refuses the inputs."""
    return _launch_bwd(name, _check_bwd_args(q, k, v, o, do, window), q, k, v, o, do, lse,
                       window)


def _launch_bwd(name, dims, q, k, v, o, do, lse, window):
    B, S, H, K, D = dims
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) \
            or lse.device != q.device:
        raise ValueError(
            f"flash_attention_bwd: lse must be the forward's float32 (B, H, S) = "
            f"({B}, {H}, {S}) on {q.device}, got "
            f"{None if lse is None else (tuple(lse.shape), lse.dtype, lse.device)}"
        )
    _check_fma(name, D, "flash_attention_bwd")
    entry = build.BWD_ENTRY_POINTS.get((name, KERNEL_DTYPES[q.dtype]))
    if entry is None:
        raise ValueError(f"flash_attention_bwd: no {name!r} backward for {q.dtype}, D = {D}")
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # The kernels read 16-byte rows (cp.async, TMA boxes): an input that
    # fails the wgmma route's layout test (a strided view, a broadcast) is
    # copied to a fresh contiguous tensor first; the LSE is read as (B, H, S).
    ins = [t if _aligned16(t) else t.clone(memory_format=torch.contiguous_format)
           for t in (q, k, v, o, do)]
    kl = build.load()
    err, grads = call_bwd(getattr(kl.lib, entry), *ins, lse.contiguous(), window=window,
                          scratch_floats=kl.lib.flash_attention_bwd_scratch_floats(B, H, S))
    kl.check(err, f"flash_attention_bwd {name} launch (B={B}, S={S}, H={H}, K={K}, D={D}, "
                  f"{q.dtype})")
    counts["flash_attention_bwd"].launches += 1
    bwd_route_launches[name] += 1
    return grads


def call_bwd(fn, q, k, v, o, do, lse, *, window=None, scratch_floats=None) -> tuple[int, tuple]:
    """Call the backward entry point ``fn`` of a built flash library (this
    checkout's, or another build's in :mod:`.compare`) on non-empty CUDA
    tensors whose rows are 16-byte aligned; returns its error code and
    (dq, dk, dv).  ``lse`` is passed as the entry's LSE argument and
    ``scratch_floats`` sizes its delta scratch (default (B, H, S), what a
    build that computes its own LSE writes into both).  Not counted:
    :func:`flash_attention_bwd` counts."""
    B, S, H, D = q.shape
    K = k.shape[2]
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, K, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    scratch = torch.empty(scratch_floats or B * H * S, dtype=torch.float32, device=q.device)
    ts = (q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in ts[:8]), lse.data_ptr(), scratch.data_ptr(),
            B, S, H, K, D, window or 0, *(st for t in ts for st in t.stride()[:3]), stream,
        )
    return err, (dq, dk, dv)
