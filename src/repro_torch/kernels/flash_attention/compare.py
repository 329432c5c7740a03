"""Time this checkout's wgmma flash kernel (or, with ``--backward``, its
backward kernel) against other builds of it, SDPA and the mma_sync kernel,
in turns, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.compare [CHECKOUT ...]
    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.compare --backward [CHECKOUT ...]

Each CHECKOUT is the root of another copy of the repository (an earlier
state of the kernel, unpacked with ``git archive``); its flash library is
built there, and its ``flash_attention_wgmma_bf16`` entry point is checked
and timed beside this checkout's.  Every build is first held against
``flash_ref`` (bf16: atol 3e-2 and a per-row relative error of 1e-2, as in
``chip_smoke.py``) on ragged, windowed, MHA and MQA shapes.  Then, per
shape, each version runs in rounds of 20 back-to-back calls between one
pair of CUDA events, the versions in turns, and the median round and its
causal TFLOP/s are printed.  The card's name and power limit come first.

``--backward`` does the same for ``flash_attention_bwd_bf16``: each build
held against ``flash_bwd_ref`` by ``ref.flash_bwd_errors``, as in
``chip_smoke.py`` (bf16: 2e-2 of the largest |plain| and per row), then timed at the training shapes
beside SDPA's backward (its fwd+bwd minus its fwd, ``enable_gqa=True``);
TFLOP/s count 2.5x the causal forward.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import build, ops
from repro_torch.kernels.flash_attention.ref import (
    BWD_ROW_REL, BWD_TOL, flash_bwd_errors, flash_bwd_ref, flash_ref)

CHECK_SHAPES = [  # (B, S, H, K, D, window)
    (1, 1, 1, 1, 64, None), (3, 129, 6, 3, 128, 16), (1, 4096, 2, 1, 128, 1000),
    (2, 100, 16, 8, 128, None), (2, 300, 8, 8, 128, None), (2, 300, 8, 1, 64, 48),
    (8, 2048, 16, 8, 128, None),
]
TIME_SHAPES = [(8, 2048, 16, 8, 128), (2, 8192, 16, 8, 128), (8, 2048, 16, 8, 64)]
BWD_CHECK_SHAPES = [
    (2, 1, 4, 2, 64, None), (2, 77, 4, 2, 16, None), (1, 300, 4, 4, 64, None),
    (2, 300, 8, 4, 128, 48), (1, 1024, 8, 8, 64, 128), (1, 1000, 16, 8, 128, None),
    (4, 4096, 16, 8, 128, None),
]
BWD_TIME_SHAPES = [(4, 4096, 16, 8, 128), (8, 2048, 16, 8, 128), (4, 4096, 16, 8, 64)]


def _entry(path: str, backward: bool = False):
    lib = ctypes.CDLL(path)
    fn = lib.flash_attention_bwd_bf16 if backward else lib.flash_attention_wgmma_bf16
    fn.argtypes = build._BWD_ARGTYPES if backward else build._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _call_bwd(fn, q, k, v, o, do, window=None):
    err, grads = ops.call_bwd(fn, q, k, v, o, do, window=window)
    if err:
        raise RuntimeError(f"flash_attention_bwd_bf16 failed: error {err}")
    return grads


def _backward(versions: dict, gen, rounds: int) -> int:
    def inputs(B, S, H, K, D):
        q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        return q, k, v, do

    bad = []
    for B, S, H, K, D, window in BWD_CHECK_SHAPES:
        q, k, v, do = inputs(B, S, H, K, D)
        o = ops.flash_attention(q, k, v, window=window)
        want = flash_bwd_ref(q, k, v, o, do, window=window)
        for name, fn in versions.items():
            _, rel, row = flash_bwd_errors(_call_bwd(fn, q, k, v, o, do, window), want)
            ok = rel <= BWD_TOL[torch.bfloat16] and row <= BWD_ROW_REL
            print(f"[check] backward {name} {(B, S, H, K, D, window)}: max abs err of max "
                  f"|plain| {rel:.3e}, max row err {row:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
            if not ok:
                bad.append((name, (B, S, H, K, D, window)))
        del want
    if bad:
        print(f"compare: out of tolerance: {bad}", file=sys.stderr)
        return 1
    for B, S, H, K, D in BWD_TIME_SHAPES:
        q, k, v, do = inputs(B, S, H, K, D)
        o = ops.flash_attention(q, k, v)
        qs, ks, vs, dos = (t.transpose(1, 2).contiguous().requires_grad_(True)
                           for t in (q, k, v, do))

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

        fns = {name: (lambda fn=fn: _call_bwd(fn, q, k, v, o, do)) for name, fn in versions.items()}
        fns["sdpa fwd"] = sdpa
        fns["sdpa fwd+bwd"] = lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
        times = _in_turns(fns, rounds, n=10)
        times["sdpa bwd"] = times["sdpa fwd+bwd"] - times["sdpa fwd"]
        flops = 2.5 * 4 * B * H * D * S * (S + 1) / 2
        for name, ms in times.items():
            print(f"[time] backward {(B, S, H, K, D)} {name}: {ms} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")
    return 0


def _in_turns(fns: dict, rounds: int, n: int = 20) -> dict:
    """Median over ``rounds`` of each callable's ms a call, in turns."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(_round_ms(fn, n))
    return {name: statistics.median(t) for name, t in times.items()}


def _build_at(root: str) -> str:
    """Build the flash library of the checkout at ``root``; its path."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.kernels.flash_attention import build; print(build.load().path)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def _call(fn, q, k, v, window=None):
    B, S, H, D = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, k.shape[2], D,
             window or 0, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_wgmma_bf16 failed: error {err}")
    return o


def _round_ms(fn, n: int = 20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", help="roots of other checkouts to compare")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--backward", action="store_true",
                    help="check and time the backward kernel instead of the forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with concurrent.futures.ThreadPoolExecutor(1 + len(args.checkouts)) as pool:
        here = pool.submit(build.load)
        others = [pool.submit(_build_at, root) for root in args.checkouts]
        versions = {"this": _entry(str(here.result().path), args.backward)}
        versions.update({root: _entry(f.result(), args.backward)
                         for root, f in zip(args.checkouts, others)})
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.backward:
        return _backward(versions, gen, args.rounds)

    def inputs(B, S, H, K, D):
        return [torch.randn((B, S, n, D), generator=gen, device="cuda").to(torch.bfloat16)
                for n in (H, K, K)]

    bad = []
    for B, S, H, K, D, window in CHECK_SHAPES:
        q, k, v = inputs(B, S, H, K, D)
        ref = flash_ref(q, k, v, window=window).float()
        for name, fn in versions.items():
            diff = _call(fn, q, k, v, window).float() - ref
            rel = float((diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())
            err = float(diff.abs().max())
            ok = err <= 3e-2 and rel <= 1e-2
            print(f"[check] {name} {(B, S, H, K, D, window)}: max abs err {err:.3e}, "
                  f"max row rel err {rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
            if not ok:
                bad.append((name, (B, S, H, K, D, window)))
    if bad:
        print(f"compare: out of tolerance: {bad}", file=sys.stderr)
        return 1
    for B, S, H, K, D in TIME_SHAPES:
        q, k, v = inputs(B, S, H, K, D)
        sdpa_args = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        fns = {name: (lambda fn=fn: _call(fn, q, k, v)) for name, fn in versions.items()}
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(*sdpa_args, is_causal=True,
                                                             enable_gqa=True)
        fns["mma_sync"] = lambda: ops.launch("mma_sync", q, k, v)
        flops = 4 * B * H * D * S * (S + 1) / 2
        for name, ms in _in_turns(fns, args.rounds).items():
            print(f"[time] {(B, S, H, K, D)} {name}: {ms} ms, {flops / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
