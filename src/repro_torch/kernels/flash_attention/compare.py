"""Time this checkout's wgmma flash kernel (or, with ``--backward``, its
backward routes) against other builds of it, SDPA and the mma_sync kernel,
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
pair of CUDA events, the versions in turns (the order reversed every other
round), and the median round and its causal TFLOP/s are printed.  The card's name and power limit come first.

``--backward`` does the same for the backward: this checkout's wgmma and
mma_sync routes, and each other build's backward entry points, each bound
by its own signature (a build with the wgmma route reads the forward's LSE;
an earlier one computes its own).  Each is held against ``flash_bwd_ref`` by
``ref.flash_bwd_errors``, as in ``chip_smoke.py`` (bf16: 2e-2 of the largest
|plain| and per row), then timed at the training shapes beside SDPA's
backward (its fwd+bwd minus its fwd, ``enable_gqa=True``); TFLOP/s count
2.5x the causal forward, and the bound is that count over the bf16 peak.

``--sass REGEX`` instead compares the machine code: for each kernel whose
mangled name matches, paired across builds by its ``ILi<D>E`` head dim and
``Lb1`` LSE flag (a build without the flag pairs as ``Lb0``), each build's
``cuobjdump -res-usage`` line, its SASS instruction count, and how many
lines of a diff against this checkout's SASS differ, in full and in opcodes
alone (addresses, encodings and operands dropped).  ``cuobjdump`` is taken
from beside ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import difflib
import pathlib
import re
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention import build, ops
from repro_torch.launch.roofline import H100_SXM
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


def _entry(path: str):
    lib = ctypes.CDLL(path)
    fn = lib.flash_attention_wgmma_bf16
    fn.argtypes = build._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _bwd_versions(label: str, path: str) -> dict:
    """The bf16 backward entry points of the library at ``path``, as
    callables (q, k, v, o, do, lse, window) -> (dq, dk, dv).  A build with
    the wgmma route reads the forward's LSE and takes the scratch its
    ``flash_attention_bwd_scratch_floats`` names; an earlier build's one
    entry point has the same arguments but writes its own LSE and delta,
    (B, H, S) each, and is given buffers of its own."""
    lib = ctypes.CDLL(path)

    def bound(fn, scratch=None):
        fn.argtypes = build._BWD_ARGTYPES
        fn.restype = ctypes.c_int

        def call(q, k, v, o, do, lse, window=None):
            B, S, H, _ = q.shape
            lse_in = lse if scratch else torch.empty_like(lse)
            err, grads = ops.call_bwd(fn, q, k, v, o, do, lse_in, window=window,
                                      scratch_floats=scratch(B, H, S) if scratch else None)
            if err:
                raise RuntimeError(f"{label} backward failed: error {err}")
            return grads
        return call

    if not hasattr(lib, "flash_attention_bwd_wgmma_bf16"):
        return {f"{label} (own LSE)": bound(lib.flash_attention_bwd_bf16)}
    scratch = lib.flash_attention_bwd_scratch_floats
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    return {f"{label} {route}": bound(getattr(lib, build.BWD_ENTRY_POINTS[(route, "bf16")]),
                                      scratch)
            for route in ("wgmma", "mma_sync")}


def _backward(paths: dict, gen, rounds: int) -> int:
    versions = {}
    for label, path in paths.items():
        versions.update(_bwd_versions(label, path))

    def inputs(B, S, H, K, D):
        q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        return q, k, v, do

    bad = []
    for B, S, H, K, D, window in BWD_CHECK_SHAPES:
        q, k, v, do = inputs(B, S, H, K, D)
        o, lse = ops.launch(ops.route(q, k, v), q, k, v, window=window, lse=True)
        want = flash_bwd_ref(q, k, v, o, do, window=window)
        for name, fn in versions.items():
            if name.endswith(" wgmma") and ops.bwd_route(q, k, v) != "wgmma":
                continue  # D outside the wgmma route's
            _, rel, row = flash_bwd_errors(fn(q, k, v, o, do, lse, window), want)
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
        o, lse = ops.launch("wgmma", q, k, v, lse=True)
        qs, ks, vs, dos = (t.transpose(1, 2).contiguous().requires_grad_(True)
                           for t in (q, k, v, do))

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

        fns = {name: (lambda fn=fn: fn(q, k, v, o, do, lse)) for name, fn in versions.items()}
        fns["sdpa fwd"] = sdpa
        fns["sdpa fwd+bwd"] = lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
        times = _in_turns(fns, rounds, n=10)
        times["sdpa bwd"] = times["sdpa fwd+bwd"] - times["sdpa fwd"]
        flops = 2.5 * 4 * B * H * D * S * (S + 1) / 2
        bound = flops / H100_SXM.peak(torch.bfloat16) * 1e3
        for name, ms in times.items():
            if name in ("sdpa fwd", "sdpa fwd+bwd"):  # not a backward's time
                print(f"[time] backward {(B, S, H, K, D)} {name}: {ms} ms")
                continue
            print(f"[time] backward {(B, S, H, K, D)} {name}: {ms} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the "
                  f"{bound:.4f} ms bound")
    return 0


def _cuobjdump(*args: str) -> str:
    tool = pathlib.Path(nvcc.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), *args], capture_output=True, text=True, check=True).stdout


def _kernel_key(name: str) -> tuple[str, str]:
    d = re.search(r"ILi(\d+)E", name)
    return (d[1] if d else "?"), ("Lb1" if "Lb1E" in name else "Lb0")


def _sass(path: str, pattern: str) -> dict[tuple, tuple[str, list[str]]]:
    """Each matching kernel of the library at ``path``: key -> (its
    ``-res-usage`` line, its SASS instructions without addresses)."""
    usage, name = {}, None
    for line in _cuobjdump("-res-usage", path).splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m[1]
        elif name and "REG:" in line:
            usage[name] = line.strip()
            name = None
    funcs, name = {}, None
    for line in _cuobjdump("-sass", path).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m[1] if re.search(pattern, m[1]) else None
            if name:
                funcs[name] = []
        elif name and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)):
            funcs[name].append(m[1])
    return {_kernel_key(n): (usage.get(n, "no -res-usage line"), ins) for n, ins in funcs.items()}


def _compare_sass(paths: dict, pattern: str) -> int:
    codes = {label: _sass(path, pattern) for label, path in paths.items()}
    here = codes.pop("this")
    if not here:
        print(f"compare: no kernel matches {pattern!r}", file=sys.stderr)
        return 1
    for key, (usage, ins) in sorted(here.items()):
        print(f"[sass] D={key[0]} {key[1]} this: {len(ins)} instructions; {usage}")
        for label, funcs in codes.items():
            if key not in funcs:
                print(f"[sass] D={key[0]} {key[1]} {label}: no such kernel")
                continue
            o_usage, o_ins = funcs[key]
            full = sum(1 for d in difflib.unified_diff(ins, o_ins, lineterm="", n=0)
                       if d[:1] in "+-" and d[:3] not in ("+++", "---"))
            ops_a, ops_b = ([next(t for t in i.split() if t[0] != "@") for i in x]
                            for x in (ins, o_ins))
            opc = sum(1 for d in difflib.unified_diff(ops_a, ops_b, lineterm="", n=0)
                      if d[:1] in "+-" and d[:3] not in ("+++", "---"))
            print(f"[sass] D={key[0]} {key[1]} {label}: {len(o_ins)} instructions; "
                  f"{o_usage}; lines differing from this: {full} in full, {opc} in opcodes")
            shown = [d for d in difflib.unified_diff(ins, o_ins, "this", label, lineterm="", n=0)]
            for d in shown[:60]:
                print(f"[sass]   {d}")
    return 0


def _in_turns(fns: dict, rounds: int, n: int = 20) -> dict:
    """Median over ``rounds`` of each callable's ms a call, in turns, the
    order reversed every other round: on an H100 the first callable of a
    fixed order read ~1.5% slow at (8, 2048, 16, 8, 128) against a copy of
    itself later in the round."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns.items())
    for r in range(rounds):
        for name, fn in order if r % 2 == 0 else order[::-1]:
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
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--backward", action="store_true",
                    help="check and time the backward routes instead of the forward")
    ap.add_argument("--sass", metavar="REGEX",
                    help="compare the machine code of the matching kernels instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with concurrent.futures.ThreadPoolExecutor(1 + len(args.checkouts)) as pool:
        here = pool.submit(build.load)
        others = [pool.submit(_build_at, root) for root in args.checkouts]
        paths = {"this": str(here.result().path)}
        paths.update({root: f.result() for root, f in zip(args.checkouts, others)})
    if args.sass:
        return _compare_sass(paths, args.sass)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.backward:
        return _backward(paths, gen, args.rounds)
    versions = {label: _entry(path) for label, path in paths.items()}

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
