#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (the
   PAop and flash-attention libraries in parallel, one ``nvcc`` per
   source, each library timed), print what ``ptxas`` reports per
   instantiation (registers, spills, the wgmma kernel's shared memory, and
   any ``wgmma ... serialized`` warning; for the PAop kernel and its
   baseline, the first port's kernel, also the shared bytes per block and
   the blocks an SM holds), and hold the probe kernel against ``2 * x``;
3. hold the PAop kernel against its plain PyTorch version on the card for
   p = 1..8 in float64 and float32 at NE in {1, 7, 4096}, and at every
   (p, NE) the main path gives it, with the tests' tolerances; hold the
   flash-attention kernels against their plain version in float32 (atol
   2e-5) and bfloat16 (atol 3e-2, and 1e-2 per-row relative) at the
   shapes of ``tests/test_flash_kernel.py``, windows {16, 48, 128},
   ragged S in {1, 7, 100, 1000}, the wgmma route's D = 64 and 128 cases,
   and the serve path's (8, 2048, 16, 8, 128), each case asserting which
   route (``ops.route``: wgmma, mma_sync or fma) launched;
4. the solve path: ``solve_beam(4, 4, precision="f64", device="cuda")`` on
   the 2-material beam (32,768 elements, 6,502,275 DoFs) with every
   kernel count zeroed just before and read just after; it must converge
   to rel_tol 1e-6 through the kernels alone, to a finite solution, and a
   small solve on the card must agree with the same solve on the CPU;
5. the serve path: qwen3-1.7b at full width in bfloat16 (28 layers,
   seeded random weights) generates 32 greedy tokens for each of 8
   requests of 2048 prompt tokens, with every count zeroed just before
   and read just after: 28 flash-attention launches per prefill batch
   and no plain call, all 28 on the wgmma route.  A 2-token warm-up at
   the same shapes, its prompts
   left-padded to 2048, keeps the q/k/v that the first and the last
   layer give the kernel, and the kernel's output on them is held
   against the plain version (1e-2 per-row relative); a reduced float32
   qwen3 must give the same tokens and logits on the card as on the CPU;
6. time the PAop apply at p in {2, 4, 8} (NE=32768, f64; p=4 is the
   fine level of the solve) beside the baseline kernel, and the flash
   kernel at (8, 2048, 16, 8, 128) bf16, beside their plain versions, a
   library call where one exists, and their bounds: rounds of back-to-back
   launches between one pair of CUDA events, the versions in turns (the
   kernel, the baseline, the plain version; the wgmma kernel, SDPA, the
   mma_sync kernel), the median round; then the host time per call of the
   wrappers (``time.perf_counter`` over back-to-back calls, no sync
   inside), with the probe's wrapper split into its parts.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.core.basis import basis_tables  # noqa: E402
from repro_torch.core.flops import paop_flops_per_elem  # noqa: E402
from repro_torch.kernels.flash_attention import build as flash_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_ref  # noqa: E402
from repro_torch.kernels.pa_elasticity import build, ops  # noqa: E402
from repro_torch.kernels.pa_elasticity.ref import paop_ref, probe_ref  # noqa: E402
from repro_torch.launch.solve import solve_beam  # noqa: E402
from repro_torch.models import attention as attention_module  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: E402
from repro_torch.solvers.gmg import hierarchy_spaces  # noqa: E402
from repro_torch.fem.mesh import beam_hex  # noqa: E402

# H100 SXM data sheet: HBM3 rate, and the peak rates used for the bound
# (f64 and bf16 with the tensor cores; f32 outside them).
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12, torch.bfloat16: 989e12}
# The tests' tolerances (docs/KERNELS.md): rtol, and atol as a fraction
# of max |plain|.
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-4, 2e-5)}
MAIN_P, MAIN_REFINE = 4, 4
PA_TIME_P = (2, 4, 8)  # orders timed at the fine level's NE, in f64
SEED = 0
# Flash attention: absolute tolerances of tests/test_flash_kernel.py on
# unit-normal inputs; (B, S, H, K, D, window) cases held against the plain
# version, and the serve path's shape.
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16 is also held row by row, ||o - ref|| / ||ref|| over each (b, s, h)
# row of D values, which scales with the values compared: late causal rows
# average many keys and are small.  Rounding p and o to bf16 reads a few
# 1e-3; a dropped or mis-rescaled tile of 64 keys on a row of n keys reads
# about sqrt(64 / n), 0.18 at n = 2048.
FLASH_ROW_REL = 1e-2
FLASH_CASES = [
    (2, 128, 4, 2, 16, None),  # the shapes of tests/test_flash_kernel.py
    (1, 256, 8, 8, 32, None),  # MHA
    (2, 64, 8, 1, 8, None),  # MQA
    (1, 512, 4, 2, 64, None),
    (1, 128, 4, 4, 32, None),
    (2, 128, 4, 2, 16, 16),  # windows
    (2, 128, 4, 2, 16, 48),
    (2, 128, 4, 2, 16, 128),
    (2, 1, 16, 8, 128, None),  # ragged S
    (2, 7, 16, 8, 128, None),
    (2, 100, 16, 8, 128, None),
    (1, 1000, 16, 8, 128, 128),
    (2, 300, 8, 8, 128, None),  # the wgmma route: MHA, MQA, windows, D = 64
    (2, 300, 8, 1, 128, 128),
    (1, 384, 8, 2, 64, 48),
    (2, 2048, 4, 2, 64, None),
]
# The serve path: qwen3-1.7b, 8 requests of 2048 prompt tokens, 32 new.
SERVE_ARCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = "qwen3-1.7b", 8, 2048, 32
FLASH_MAIN = (SERVE_REQUESTS, SERVE_PROMPT, 16, 8, 128)  # (B, S, H, K, D)
SMALL_SERVE_PROMPTS = (5, 9, 3, 12, 7)
SMALL_SERVE_REL = 1e-4  # card vs CPU logits, of max |logit| (f32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def ptxas_summary(log: str, smem_bytes=None, pa_config=None) -> list[str]:
    """One line per kernel instantiation: registers and spills, the dynamic
    shared memory ``smem_bytes(D)`` gives for the wgmma kernel, and for the
    PAop kernels what ``pa_config(name, dtype, D)`` (``KernelLibrary.config``)
    gives; then every ptxas warning that wgmma instructions were
    serialized."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if re.search(r"wgmma.*serializ", line):
            rows.append(f"  WARNING {line.strip()}")
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"pa_elasticity_(baseline_)?kernelI([df])Li(\d+)E", name)
            f = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
            tc = re.search(r"flash_fwd_tc_kernelILi(\d+)ELi(\d+)E", name)
            wg = re.search(r"flash_fwd_wgmma_kernelILi(\d+)E", name)
            if wg:
                d = int(wg.group(1))
                smem = f", {smem_bytes(d)} B dynamic shared memory" if smem_bytes else ""
                name = f"flash_attention<bf16, D={d}, BQ=BK=128> (wgmma, TMA{smem})"
            elif k:
                kname = "pa_elasticity_baseline" if k.group(1) else "pa_elasticity"
                dt = torch.float64 if k.group(2) == "d" else torch.float32
                d = int(k.group(3))
                name = f"{kname}<{str(dt)[6:]}, D={d}, Q={d + 1}>"
                if pa_config:
                    c = pa_config(kname, dt, d)
                    name += (f" ({c['threads']} threads, {c['elems']} elements, "
                             f"{c['smem_bytes']} B shared per block, "
                             f"{c['blocks_per_sm']} blocks per SM)")
            elif f:
                name = f"flash_attention<{'f32' if f.group(1) == 'f' else 'bf16'}, D={f.group(2)}, BK={f.group(3)}> (FMA)"
            elif tc:
                name = f"flash_attention<bf16, D={tc.group(1)}, BK={tc.group(2)}> (mma.sync)"
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


def round_ms(fn, n: int) -> float:
    """Device time per call of ``n`` back-to-back calls of ``fn()`` between
    one pair of CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def event_ms(fns: dict, n: int, rounds: int, warmup: int = 2) -> dict[str, float]:
    """Median over ``rounds`` of :func:`round_ms` for each of ``fns``
    (name -> callable), the callables timed in turns within each round."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(round_ms(fn, n))
    return {name: statistics.median(t) for name, t in times.items()}


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


def host_us(fn, n: int = 200, warmup: int = 20) -> float:
    """Host time per call of ``n`` back-to-back calls of ``fn()``, in
    microseconds, with no sync inside (what a caller's thread pays to
    enqueue the call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def reset_all_counts() -> None:
    ops.reset_counts()
    flash_ops.reset_counts()


def expected_route(dt, D: int, pad: int) -> str:
    """The flash kernel each case must launch: bf16 at D in {64, 128} with
    16-byte rows takes wgmma, other bf16 at D >= 16 mma_sync, the rest fma."""
    if dt == torch.bfloat16 and D in (64, 128) and pad == 0:
        return "wgmma"
    return "mma_sync" if dt == torch.bfloat16 and D >= 16 else "fma"


def all_counts() -> dict[str, tuple[int, int]]:
    both = {**ops.counts, **flash_ops.counts}
    return {k: (c.launches, c.plain_calls) for k, c in both.items()}


def flash_inputs(B, S, H, K, D, dtype, gen, pad: int = 0) -> tuple:
    """Unit-normal q, k, v; ``pad`` > 0 gives views of wider rows, whose
    strides are no multiple of 8 elements (the kernel's unaligned loads)."""
    q = torch.randn((B, S, H, D + pad), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, K, D + pad), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, K, D + pad), generator=gen, device="cuda").to(dtype)
    return q[..., :D], k[..., :D], v[..., :D]


def flash_bound(q, k, v) -> tuple[float, str]:
    """Least time for one causal call: the larger of bytes over the memory
    rate (q, k, v read once, o written once) and the causal band's
    operations, 4 B H D S(S+1)/2, over the dtype's peak rate."""
    B, S, H, D = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * D * S * (S + 1) / 2
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_check(o, ref, dt) -> tuple[float, float, bool]:
    """(max abs err, max per-row relative err, within tolerance)."""
    diff = o.float() - ref.float()
    abs_err = float(diff.abs().max())
    row_rel = float((diff.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)).max())
    ok = abs_err <= FLASH_ATOL[dt] and (dt != torch.bfloat16 or row_rel <= FLASH_ROW_REL)
    return abs_err, row_rel, ok


def capture_flash_inputs(calls: set[int]) -> tuple[list, object]:
    """Wrap the attention module's kernel call to keep clones of the q, k,
    v of the given calls (0-based, in call order); returns the list they
    go into and the wrapped function, to put back."""
    kept, inner, seen = [], attention_module.flash_attention, [0]

    def keeping(q, k, v, *, window=None):
        if seen[0] in calls:
            kept.append((seen[0], q.clone(), k.clone(), v.clone(), window))
        seen[0] += 1
        return inner(q, k, v, window=window)

    attention_module.flash_attention = keeping
    return kept, inner


def record_logits(eng: ServeEngine) -> list:
    """Wrap the engine's host sampler to keep every step's logits."""
    seen, sample = [], eng._sample

    def recording(logits, temps):
        seen.append(logits.copy())
        return sample(logits, temps)

    eng._sample = recording
    return seen


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.cpu().numpy()


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

    # ---- 2. build (both libraries at once) + probe
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(build.load), pool.submit(flash_build.load)]
        kl, fl = (b.result() for b in builds)
    for lib, smem, cfg in ((kl, None, kl.config),
                           (fl, fl.lib.flash_attention_wgmma_smem_bytes, None)):
        print(f"[build] {lib.path.name}: {lib.build_seconds:.1f} s (0 = cached)")
        for row in ptxas_summary(lib.log, smem, cfg):
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

    flash_cases = [(c, dt, 0) for c in FLASH_CASES for dt in (torch.float32, torch.bfloat16)]
    flash_cases += [((2, 100, 16, 8, 128, None), dt, 2) for dt in (torch.float32, torch.bfloat16)]
    flash_cases.append(((*FLASH_MAIN, None), torch.bfloat16, 0))
    for (B, S, H, K, D, window), dt, pad in flash_cases:
        q, k, v = flash_inputs(B, S, H, K, D, dt, gen, pad)
        want = expected_route(dt, D, pad)
        before = dict(flash_ops.route_launches)
        o = flash_ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        moved = [r for r in flash_ops.ROUTES if flash_ops.route_launches[r] != before[r]]
        flash_err, row_rel, ok = flash_check(o, flash_ref(q, k, v, window=window), dt)
        print(f"[flash vs plain] (B,S,H,K,D)=({B},{S},{H},{K},{D}) window={window} "
              f"{str(dt)[6:]}{' strided' if pad else ''} route {moved}: max abs err "
              f"{flash_err:.3e}, max row rel err {row_rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if moved != [want]:
            bad.append(((B, S, H, K, D, window), str(dt), pad, f"route {moved}, expected {want}"))
        elif not ok:
            bad.append(((B, S, H, K, D, window), str(dt), pad, flash_err))
    if bad:
        raise SystemExit(f"flash kernel disagrees with its plain version: {bad}")
    flash_main_err = flash_err  # the last case is the serve path's shape
    del q, k, v, o

    # ---- 4. the solve path, counted
    reset_all_counts()
    rep = solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda",
                     keep_solution=True)
    solve_counts = all_counts()
    main_counts = {k: solve_counts[k] for k in ops.counts}
    print(f"[solve] p={rep.p} refine={MAIN_REFINE} nelem={rep.nelem} "
          f"ndof={rep.ndof} iters={rep.iterations} rel={rep.final_rel_norm:.3e} "
          f"converged={rep.converged}")
    print(f"[solve] prec={rep.t_precond}s form={rep.t_form_ls}s "
          f"solve={rep.t_solve}s total={rep.t_total}s "
          f"DoF/s(solve)={rep.ndof / rep.t_solve} "
          f"DoF*iter/s={rep.ndof * rep.iterations / rep.t_solve}")
    print(f"[solve] counts (launches, plain_calls): {solve_counts}")
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
    del small_gpu, small_cpu
    torch.cuda.empty_cache()

    # ---- 5. the serve path, counted: qwen3-1.7b at full width, bf16
    cfg = get_config(SERVE_ARCH)
    eng = ServeEngine(cfg, max_len=SERVE_PROMPT + SERVE_NEW + 8,
                      max_batch=SERVE_REQUESTS, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (SERVE_PROMPT,)).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQUESTS)]
    # Warm-up at the same shapes (cuBLAS's first calls pick their kernels),
    # so that the counted run's times are steady-state ones.  Its prompts
    # are cut to 2048 - 32 i tokens, so the batch is left-padded to 2048;
    # the q/k/v of the first and the last layer's prefill are kept and the
    # kernel is held against its plain version on them (after qk-norm and
    # RoPE, as the model gives them).
    kept, inner = capture_flash_inputs({0, cfg.n_layers - 1})
    eng.generate([Request(prompt=r.prompt[32 * i:], max_new_tokens=2)
                  for i, r in enumerate(reqs)])
    attention_module.flash_attention = inner
    if len(kept) != 2:
        raise SystemExit(f"serve warm-up kept the q/k/v of {len(kept)} layers, expected 2")
    for layer, q, k, v, window in kept:
        o = flash_ops.flash_attention(q, k, v, window=window)
        ref = flash_ref(q, k, v, window=window)
        # The model's values are not unit-normal: only the per-row check.
        real_err, real_rel, _ = flash_check(o, ref, q.dtype)
        ok = real_rel <= FLASH_ROW_REL
        print(f"[flash vs plain] serve layer {layer} q/k/v {tuple(q.shape)} {str(q.dtype)[6:]}: "
              f"max abs err {real_err:.3e} (max |ref| {float(ref.float().abs().max()):.3e}), "
              f"max row rel err {real_rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            raise SystemExit(f"flash kernel disagrees with its plain version on layer "
                             f"{layer}'s prefill q/k/v: {real_rel}")
    del kept, q, k, v, o, ref
    eng.stats = ServeStats()
    logits_seen = record_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    eng.generate(reqs)
    serve_counts = all_counts()
    serve_routes = dict(flash_ops.route_launches)
    st = eng.stats
    print(f"[serve] {cfg.name} {cfg.dtype} L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} K={cfg.n_kv_heads} hd={cfg.head_dim_} vocab={cfg.vocab}: "
          f"{len(reqs)} requests x {SERVE_PROMPT} prompt tokens, {SERVE_NEW} new")
    print(f"[serve] prefill {st.prefill_s} s ({st.prompt_tokens / st.prefill_s} prompt "
          f"tok/s, {st.prefill_batches} batches), decode {st.decode_s} s "
          f"({st.decode_tokens / st.decode_s} decode tok/s, {st.decode_steps} steps), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[serve] counts (launches, plain_calls): {serve_counts}; flash launches per "
          f"route: {serve_routes}")
    launches, plain = serve_counts["flash_attention"]
    want_routes = {**dict.fromkeys(flash_ops.ROUTES, 0), "wgmma": cfg.n_layers * st.prefill_batches}
    if launches != cfg.n_layers * st.prefill_batches or plain != 0 or serve_routes != want_routes:
        raise SystemExit(f"serve path did not run only through the wgmma flash kernel: "
                         f"launches={launches} plain_calls={plain} routes={serve_routes}, "
                         f"expected {cfg.n_layers} x {st.prefill_batches} batches on wgmma")
    if any(len(r.out_tokens) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in r.out_tokens)
           for r in reqs):
        raise SystemExit("serve path: a request did not get 32 tokens in [0, vocab)")
    if not all(np.isfinite(lg).all() for lg in logits_seen):
        raise SystemExit("serve path: non-finite logits")
    print(f"[serve] req0 tokens: {reqs[0].out_tokens}")
    del eng, logits_seen
    torch.cuda.empty_cache()

    # A reduced qwen3 in f32 on the card against the CPU, same weights.
    small_cfg = dataclasses.replace(get_reduced(SERVE_ARCH), dtype="float32")
    weights = numpy_tree(init_params(torch.Generator().manual_seed(SEED), small_cfg))
    prompts = [rng.integers(0, small_cfg.vocab, (n,)).astype(np.int32)
               for n in SMALL_SERVE_PROMPTS]
    small = {}
    for dev in ("cuda", "cpu"):
        seng = ServeEngine(small_cfg, params=lm_params(weights, small_cfg, device=dev),
                           max_len=32, max_batch=4, device=dev)
        seen = record_logits(seng)
        sreqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        seng.generate(sreqs)
        small[dev] = ([r.out_tokens for r in sreqs], seen)
    (tok_gpu, lg_gpu), (tok_cpu, lg_cpu) = small["cuda"], small["cpu"]
    lg_rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(lg_gpu, lg_cpu))
    print(f"[small serve] reduced f32, {len(prompts)} requests, max_batch 4: tokens "
          f"{'equal' if tok_gpu == tok_cpu else 'DIFFER'}, max logit diff {lg_rel:.3e} "
          f"of max |logit|")
    if tok_gpu != tok_cpu or lg_rel > SMALL_SERVE_REL:
        raise SystemExit("small serve on the card disagrees with the CPU")

    # ---- 6. time the PAop apply (kernel, baseline, plain) and the flash kernel
    ne = main_shapes[-1][1]
    pa_t = {}
    for p in PA_TIME_P:
        args = pa_inputs(p, ne, torch.float64, gen)
        y = ops.pa_elasticity(*args)
        ref = paop_ref(*args)
        max_abs, rel, ok = compare(y, ref, torch.float64)
        _, base_rel, base_ok = compare(ops.launch_baseline(*args), ref, torch.float64)
        if not (ok and base_ok):
            raise SystemExit(f"p={p} NE={ne} apply out of tolerance: kernel {rel}, "
                             f"baseline {base_rel}")
        del ref
        t = event_ms({"kernel": lambda: ops.pa_elasticity(*args),
                      "baseline": lambda: ops.launch_baseline(*args),
                      "plain": lambda: paop_ref(*args)}, n=10, rounds=5)
        bound_ms, bound_by = paop_bound(args, y, p)
        pa_t[p] = {**t, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs": max_abs}
        print(f"[time] pa_elasticity p={p} NE={ne} f64, in turns, median of 5 rounds of 10: "
              f"kernel {t['kernel']} ms ({100 * bound_ms / t['kernel']}% of bound), baseline "
              f"{t['baseline']} ms ({100 * bound_ms / t['baseline']}% of bound), plain "
              f"{t['plain']} ms; bound {bound_ms} ms ({bound_by}); kernel "
              f"{t['baseline'] / t['kernel']}x faster than the baseline; max rel err "
              f"kernel {rel:.3e}, baseline {base_rel:.3e}")
        del args, y
    main_t = pa_t[MAIN_P]
    flash_args = flash_inputs(*FLASH_MAIN, torch.bfloat16, gen)
    if flash_ops.route(*flash_args) != "wgmma":
        raise SystemExit("the serve shape's timing inputs do not take the wgmma route")
    # SDPA wants (B, H, S, D); the layout change stays outside the timing.
    sdpa_args = [t.transpose(1, 2).contiguous() for t in flash_args]
    flash_t = event_ms({
        "wgmma": lambda: flash_ops.launch("wgmma", *flash_args),
        "sdpa": lambda: F.scaled_dot_product_attention(*sdpa_args, is_causal=True,
                                                       enable_gqa=True),
        "mma_sync": lambda: flash_ops.launch("mma_sync", *flash_args),
    }, n=20, rounds=5)
    flash_ms, flash_lib_ms, flash_old_ms = flash_t["wgmma"], flash_t["sdpa"], flash_t["mma_sync"]
    flash_plain_ms = event_ms({"plain": lambda: flash_ref(*flash_args)}, n=3, rounds=3)["plain"]
    flash_bound_ms, flash_bound_by = flash_bound(*flash_args)
    print(f"[time] flash_attention (B,S,H,K,D)={FLASH_MAIN} bf16, in turns, median of 5 "
          f"rounds of 20: wgmma kernel {flash_ms} ms, SDPA {flash_lib_ms} ms, mma_sync "
          f"kernel {flash_old_ms} ms; plain {flash_plain_ms} ms (median of 3 rounds of 3); "
          f"bound {flash_bound_ms} ms ({flash_bound_by}): wgmma {100 * flash_bound_ms / flash_ms}% "
          f"of bound, {flash_ms / flash_lib_ms}x SDPA's time; mma_sync "
          f"{100 * flash_bound_ms / flash_old_ms}% of bound")
    pa_args = pa_inputs(MAIN_P, ne, torch.float64, gen)
    po = torch.empty_like(px)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (px.data_ptr(), po.data_ptr(), px.numel())
    host = {
        "ops.probe": host_us(lambda: ops.probe(px)),
        "torch.mul": host_us(lambda: torch.mul(px, 2.0)),
        f"ops.pa_elasticity p={MAIN_P}": host_us(lambda: ops.pa_elasticity(*pa_args)),
        "flash_ops.launch wgmma": host_us(lambda: flash_ops.launch("wgmma", *flash_args)),
    }
    probe_parts = {
        "build.load()": host_us(build.load),
        "checks (dtype, is_contiguous, is_cuda)": host_us(
            lambda: (px.dtype != torch.float32, px.is_contiguous(), px.is_cuda)),
        "torch.empty_like": host_us(lambda: torch.empty_like(px)),
        "get_device() == current_device()": host_us(
            lambda: px.get_device() == torch.cuda.current_device()),
        "raw current stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "current_stream().cuda_stream (not used)": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "2 x data_ptr()": host_us(lambda: (px.data_ptr(), po.data_ptr())),
        "ctypes call": host_us(lambda: kl.probe(*ptrs, stream)),
    }
    print(f"[host] us per call, mean of 200 back-to-back calls after 20, no sync inside: "
          f"{host}; the probe wrapper's parts: {probe_parts}")
    del flash_args, sdpa_args, pa_args
    probe_t = event_ms({"kernel": lambda: ops.probe(px), "plain": lambda: probe_ref(px),
                        "library": lambda: torch.mul(px, 2.0)}, n=100, rounds=5)
    probe_ms, probe_plain_ms, probe_lib_ms = probe_t["kernel"], probe_t["plain"], probe_t["library"]
    probe_bound = 2 * px.numel() * px.element_size() / MEM_BYTES_PER_S * 1e3
    print(f"[time] probe (8, 128) f32, in turns, median of 5 rounds of 100: kernel "
          f"{probe_ms} ms, plain {probe_plain_ms} ms, torch.mul {probe_lib_ms} ms")

    kernels = [
        {
            "name": "pa_elasticity",
            "route": "cuda",
            "source": "src/repro_torch/kernels/pa_elasticity/csrc/pa_elasticity.cu",
            "replaces": "src/repro/kernels/pa_elasticity/pa_elasticity.py:85",
            "launches": main_counts["pa_elasticity"][0],
            "max_abs_err": main_t["max_abs"],
            "ms": main_t["kernel"],
            "plain_ms": main_t["plain"],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
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
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:42",
            "launches": serve_counts["flash_attention"][0],
            "max_abs_err": flash_main_err,
            "ms": flash_ms,
            "plain_ms": flash_plain_ms,
            "bound_ms": flash_bound_ms,
            "bound_by": flash_bound_by,
            "library_ms": flash_lib_ms,
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
