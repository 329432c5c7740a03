#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/pa_elasticity/csrc``
   (timed), print what ``ptxas`` reports per instantiation, and hold the
   probe kernel against ``2 * x``;
3. hold the PAop kernel against its plain PyTorch version on the card for
   p = 1..8 in float64 and float32 at NE in {1, 7, 4096}, and at every
   (p, NE) the main path gives it, with the tests' tolerances;
4. the main path: ``solve_beam(4, 4, precision="f64", device="cuda")`` on
   the 2-material beam (32,768 elements, 6,502,275 DoFs) with every
   kernel count zeroed just before and read just after; it must converge
   to rel_tol 1e-6 through the kernels alone, to a finite solution, and a
   small solve on the card must agree with the same solve on the CPU;
5. time the fine-level kernel apply (p=4, NE=32768, f64) with CUDA events
   beside its plain version and its bound.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core.basis import basis_tables  # noqa: E402
from repro_torch.core.flops import paop_flops_per_elem  # noqa: E402
from repro_torch.kernels.pa_elasticity import build, ops  # noqa: E402
from repro_torch.kernels.pa_elasticity.ref import paop_ref, probe_ref  # noqa: E402
from repro_torch.launch.solve import solve_beam  # noqa: E402
from repro_torch.solvers.gmg import hierarchy_spaces  # noqa: E402
from repro_torch.fem.mesh import beam_hex  # noqa: E402

# H100 SXM data sheet: HBM3 rate, and the peak rates used for the bound
# (f64 with the tensor cores; f32 outside them).
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
# The tests' tolerances (docs/KERNELS.md): rtol, and atol as a fraction
# of max |plain|.
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-4, 2e-5)}
MAIN_P, MAIN_REFINE = 4, 4
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation: registers and spills."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"pa_elasticity_kernelI([df])Li(\d+)ELi(\d+)E", name)
            if k:
                name = f"pa_elasticity<{'f64' if k.group(1) == 'd' else 'f32'}, D={k.group(2)}, Q={k.group(3)}>"
            elif "probe_kernel" in name:
                name = "probe"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill st/ld {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"  {name}: {m.group(1)} registers, {spill}")
            name, spill = None, ""
    return rows


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pa_inputs(p: int, ne: int, dtype, gen: torch.Generator) -> tuple:
    tb = basis_tables(p)
    d, q = tb.d1d, tb.q1d
    dev = "cuda"
    x = torch.randn((ne, 3, d, d, d), generator=gen, dtype=dtype, device=dev)
    lam = torch.rand((ne, q, q, q), generator=gen, dtype=dtype, device=dev) + 0.5
    mu = torch.rand((ne, q, q, q), generator=gen, dtype=dtype, device=dev) + 0.5
    # A non-diagonal J^{-1}, as a linear_map mesh gives.
    jinv = torch.diag(torch.tensor([2.0, 3.0, 4.0], dtype=dtype, device=dev))
    jinv = jinv + 0.1 * torch.randn((3, 3), generator=gen, dtype=dtype, device=dev)
    B = torch.as_tensor(tb.B, dtype=dtype, device=dev)
    G = torch.as_tensor(tb.G, dtype=dtype, device=dev)
    return x, lam, mu, jinv, B, G


def compare(y, ref, dtype) -> tuple[float, float, bool]:
    """(max abs err, max rel err against max |ref|, within tolerance)."""
    rtol, atol_frac = TOL[dtype]
    scale = float(ref.abs().max())
    diff = (y - ref).abs()
    ok = bool((diff <= atol_frac * scale + rtol * ref.abs()).all())
    err = float(diff.max())
    return err, err / scale if scale else err, ok


def paop_bound(args, y, p: int) -> tuple[float, str]:
    """Least time for one apply: the larger of bytes over the memory rate
    (each input read once, the output written once) and FLOPs over the
    peak rate of the dtype."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y))
    flops = paop_flops_per_elem(p) * args[0].shape[0]
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[args[0].dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # ---- 1. the card
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build + probe
    kl = build.load()
    print(f"[build] {kl.path.name}: {kl.build_seconds:.1f} s (0 = cached)")
    for row in ptxas_summary(kl.log):
        print(row)
    px = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
    po = ops.probe(px)
    probe_err = float((po - probe_ref(px)).abs().max())
    if probe_err != 0.0:
        raise SystemExit(f"probe kernel disagrees with 2*x: {probe_err}")
    print(f"[probe] o = 2x on (8, 128) f32: max abs err {probe_err}")

    # ---- 3. kernel vs plain on the card
    main_shapes = [
        (sp.p, sp.nelem)
        for sp in hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)
    ]
    cases = [(dt, p, ne) for dt in (torch.float64, torch.float32)
             for p in ops.SUPPORTED_P for ne in (1, 7, 4096)]
    cases += [(torch.float64, p, ne) for p, ne in main_shapes]
    bad = []
    for dt, p, ne in cases:
        args = pa_inputs(p, ne, dt, gen)
        y = ops.pa_elasticity(*args)
        torch.cuda.synchronize()
        _, rel, ok = compare(y, paop_ref(*args), dt)
        tag = "f64" if dt == torch.float64 else "f32"
        print(f"[paop vs plain] p={p} {tag} NE={ne}: max rel err {rel:.3e} "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            bad.append((p, tag, ne, rel))
    if bad:
        raise SystemExit(f"PAop kernel disagrees with its plain version: {bad}")

    # ---- 4. the main path, counted
    ops.reset_counts()
    rep = solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda",
                     keep_solution=True)
    main_counts = {k: (c.launches, c.plain_calls) for k, c in ops.counts.items()}
    print(f"[solve] p={rep.p} refine={MAIN_REFINE} nelem={rep.nelem} "
          f"ndof={rep.ndof} iters={rep.iterations} rel={rep.final_rel_norm:.3e} "
          f"converged={rep.converged}")
    print(f"[solve] prec={rep.t_precond}s form={rep.t_form_ls}s "
          f"solve={rep.t_solve}s total={rep.t_total}s "
          f"DoF/s(solve)={rep.ndof / rep.t_solve} "
          f"DoF*iter/s={rep.ndof * rep.iterations / rep.t_solve}")
    print(f"[solve] counts (launches, plain_calls): {main_counts}")
    if not (rep.converged and rep.final_rel_norm <= 1e-6):
        raise SystemExit("main-path solve did not converge to 1e-6")
    for name, (launches, plain) in main_counts.items():
        if launches == 0 or plain != 0:
            raise SystemExit(f"main path did not run only through {name}: "
                             f"launches={launches} plain_calls={plain}")
    x = rep.x
    if tuple(x.shape) != (rep.ndof // 3, 3) or not bool(torch.isfinite(x).all()):
        raise SystemExit("main-path solution is not finite of shape (nscalar, 3)")
    print(f"[solve] max |u_z| = {float(x[:, 2].abs().max()):.6e}")
    del x, rep
    torch.cuda.empty_cache()

    # A small solve on the card against the same solve on the CPU (plain
    # version), from the same power-iteration start vectors.
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    small_gpu = solve_beam(2, 1, device="cuda", start_vectors=sv, keep_solution=True)
    small_cpu = solve_beam(2, 1, device="cpu", start_vectors=sv, keep_solution=True)
    sdiff = float((small_gpu.x.cpu() - small_cpu.x).abs().max())
    sscale = float(small_cpu.x.abs().max())
    print(f"[small solve] p=2 refine=1 iters card/cpu "
          f"{small_gpu.iterations}/{small_cpu.iterations}, max rel diff "
          f"{sdiff / sscale:.3e}")
    if small_gpu.iterations != small_cpu.iterations or sdiff > 1e-10 * sscale:
        raise SystemExit("small solve on the card disagrees with the CPU")

    # ---- 5. time the fine-level apply
    ne = main_shapes[-1][1]
    args = pa_inputs(MAIN_P, ne, torch.float64, gen)
    y = ops.pa_elasticity(*args)
    ref = paop_ref(*args)
    max_abs, rel, ok = compare(y, ref, torch.float64)
    if not ok:
        raise SystemExit(f"fine-level apply out of tolerance: {rel}")
    del ref
    kernel_ms = event_ms(lambda: ops.pa_elasticity(*args), reps=30)
    plain_ms = event_ms(lambda: paop_ref(*args), reps=20)
    bound_ms, bound_by = paop_bound(args, y, MAIN_P)
    print(f"[time] pa_elasticity p={MAIN_P} NE={ne} f64: kernel {kernel_ms} ms "
          f"(median of 30), plain {plain_ms} ms (median of 20), bound "
          f"{bound_ms} ms ({bound_by}), {100 * bound_ms / kernel_ms}% of bound")
    probe_ms = event_ms(lambda: ops.probe(px), reps=30)
    probe_plain_ms = event_ms(lambda: probe_ref(px), reps=30)
    probe_lib_ms = event_ms(lambda: torch.mul(px, 2.0), reps=30)
    probe_bound = 2 * px.numel() * px.element_size() / MEM_BYTES_PER_S * 1e3

    kernels = [
        {
            "name": "pa_elasticity",
            "route": "cuda",
            "source": "src/repro_torch/kernels/pa_elasticity/csrc/pa_elasticity.cu",
            "replaces": "src/repro/kernels/pa_elasticity/pa_elasticity.py:85",
            "launches": main_counts["pa_elasticity"][0],
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
        {
            "name": "probe",
            "route": "cuda",
            "source": "src/repro_torch/kernels/pa_elasticity/csrc/probe.cu",
            "replaces": "src/repro/kernels/pa_elasticity/ops.py:60",
            "launches": main_counts["probe"][0],
            "max_abs_err": probe_err,
            "ms": probe_ms,
            "plain_ms": probe_plain_ms,
            "bound_ms": probe_bound,
            "bound_by": "bytes",
            "library_ms": probe_lib_ms,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
