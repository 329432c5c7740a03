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
   (p, NE) the single and the batched solve give it (S * NE elements, and
   the coarse probe's n * S * NE), with the tests' tolerances; hold the
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
5. the batched solve path: ``BatchedGMGSolver(beam_hex(), 4, 4,
   precision="f64", device="cuda")`` at S = 8 requests of the reference
   ``serve_solve`` workload (``repro_torch.launch.workload``: 4 rows of
   attribute dicts, 4 of ``lognormal:0`` per-element fields; rel_tol 1e-8
   and 1e-6 in turns).  A cold ``solve`` first, then each row alone
   through a warm ``solve_beam``, timed; then, with every count zeroed
   just before and read just after, a warm run of the user's entry
   points: a new solver, ``prepare`` and one ``run_chunk`` to the end,
   each timed between synchronize fences, with its peak memory, and
   compared with the rows' summed ``solve_beam`` times.  Every row must
   converge through the kernels alone, rows 0 and 4 must match
   ``solve_beam`` of their own scenario (same iterations, x within 1e-10
   of max |x|), and the warm run must equal the cold one bitwise.  Host syncs per ``solve`` are counted
   under ``torch.cuda.set_sync_debug_mode("warn")``; the folded coarse
   probe is timed beside a column-by-column loop, and a last prepare +
   run_chunk runs under ``torch.profiler`` for the device's busy share in
   each.  A small batched solve (p=2, refine=1, S=3) must agree with the
   CPU, and its chunked run and a masked row refill must be bitwise where
   they should be;
5b. the solve service: ``ElasticityService(max_batch=8, precision="f64",
   device="cuda")`` on 16 requests of the same ``serve_solve`` traffic
   (``--n-requests 16 --max-batch 8``: requests 0-3 and 8-11 attribute
   dicts, 4-7 and 12-15 ``lognormal:0`` fields, so 0-7 are phase 5's batch
   and 12-15 repeat 4-7), each run with every count zeroed just before and
   read just after: ``solve`` (generational; generation 0 must give phase
   5's iterations), then ``solve_continuous`` under the fixed and the
   adaptive chunk policy (chunks of 8; the adaptive run under sync debug
   mode), each request with the generational run's iterations and flags
   and the kept solutions of requests 0, 4, 8 and 12 within 1e-10 of max
   |x|, through the kernels alone; scenarios/s of each on the host clock
   between fences, latency quantiles, the scheduler summary (chunks,
   wasted iterations, refills), prep calls and copies, host syncs per
   step, peak memory; and a last continuous run under ``torch.profiler``
   with a fencing ``SpanRecorder``, whose per-ticket queue_wait + compute +
   overhead must equal the wall, its Chrome trace written to a temporary
   directory.  A small service (p=2, refine=1, 6 requests, max_batch 4,
   continuous) must agree with the CPU;
6. the serve path: qwen3-1.7b at full width in bfloat16 (28 layers,
   seeded random weights) generates 32 greedy tokens for each of 8
   requests of 2048 prompt tokens, with every count zeroed just before
   and read just after: 28 flash-attention launches per prefill batch
   and no plain call, all 28 on the wgmma route.  A 2-token warm-up at
   the same shapes, its prompts
   left-padded to 2048, keeps the q/k/v that the first and the last
   layer give the kernel, and the kernel's output on them is held
   against the plain version (1e-2 per-row relative); a reduced float32
   qwen3 must give the same tokens and logits on the card as on the CPU;
7. time the PAop apply at p in {2, 4, 8} (NE=32768, f64; p=4 is the
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
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402
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
from repro_torch.launch.serve_solve import make_workload as serve_workload  # noqa: E402
from repro_torch.launch.workload import make_workload  # noqa: E402
from repro_torch.obs import MetricsRegistry, SpanRecorder, diff_snapshots  # noqa: E402
from repro_torch.profiling import print_profile  # noqa: E402
from repro_torch.models import attention as attention_module  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve import elasticity_service  # noqa: E402
from repro_torch.serve.chunk_policy import SchedulerTrace, make_chunk_policy  # noqa: E402
from repro_torch.serve.elasticity_service import ElasticityService  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: E402
from repro_torch.core.geometry import MATERIALS_BEAM  # noqa: E402
from repro_torch.solvers.batched import BatchedGMGSolver  # noqa: E402
from repro_torch.solvers.coarse import probe_coarse_matrix  # noqa: E402
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
# The batched solve path: S = 8 rows, the reference's serve_solve --max-batch
# default, at its --rel-tol default; rows 0 and 4 (a dict and a field) are
# held against solve_beam.
BATCH_S, BATCH_BASE_TOL, BATCH_CHECK_ROWS = 8, 1e-6, (0, 4)
# The solve service: 16 requests of the same traffic (serve_solve's example
# --n-requests 16 --max-batch 8), continuous chunks of 8 (its default);
# four requests keep their solutions for the continuous-vs-generational check.
SERVICE_N, SERVICE_CHUNK, SERVICE_KEEP = 16, 8, (0, 4, 8, 12)


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


def batched_scenarios() -> tuple[list, np.ndarray, np.ndarray]:
    """S = 8 requests of the reference's serve_solve workload (its
    ``make_workload``, copied in ``repro_torch.launch.workload``) at
    refine 4 and base_tol 1e-6: rows 0-3 with attribute dicts, rows 4-7
    with ``lognormal:SEED`` per-element fields; each row's traction and
    rel_tol (1e-8 for even rows, 1e-6 for odd) those of its request."""
    dicts, trs, tols = make_workload(BATCH_S, MAIN_REFINE, BATCH_BASE_TOL)
    fields, _, _ = make_workload(BATCH_S, MAIN_REFINE, BATCH_BASE_TOL, f"lognormal:{SEED}")
    half = BATCH_S // 2
    return dicts[:half] + fields[half:], trs, tols


def count_syncs(fn):
    """(fn(), the host syncs it made): the synchronizing CUDA operations
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports while it runs."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def small_batched_check() -> None:
    """p=2, refine=1, S=3 (dict, field, dict; rel_tol 1e-6, 1e-8, 1e-10) on
    the card and on the CPU from the same start vectors: iterations equal,
    solutions within 1e-10 relative.  On the card, chunks of 3 to the end
    equal one uninterrupted chunk bitwise, and a row refilled through
    prepare(reset_mask) + run_chunk(do_reset=True) leaves the other rows
    bitwise as they would be without it."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    rng = np.random.default_rng(SEED)
    ne = spaces[-1].nelem
    mats = [MATERIALS_BEAM, (rng.lognormal(0, 0.5, ne), rng.lognormal(0, 0.5, ne)),
            {1: (10.0, 5.0), 2: (2.0, 2.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2], [0.0, 0.0, -5e-3]])
    tols = np.array([1e-6, 1e-8, 1e-10])
    gpu = BatchedGMGSolver(beam_hex(), 1, 2, device="cuda", start_vectors=sv)
    cpu = BatchedGMGSolver(beam_hex(), 1, 2, device="cpu", start_vectors=sv)
    a, b = gpu.solve(mats, trs, tols), cpu.solve(mats, trs, tols)
    diff = float((a.x.cpu() - b.x).abs().max()) / float(b.x.abs().max())
    print(f"[small batched] p=2 refine=1 S=3 iters card/cpu {a.iterations.tolist()}/"
          f"{b.iterations.tolist()}, max rel diff {diff:.3e}")
    if not torch.equal(a.iterations.cpu(), b.iterations) or diff > 1e-10 \
            or not bool(b.converged.all()):
        raise SystemExit("small batched solve on the card disagrees with the CPU")
    lam, mu = gpu.pack_materials(mats)
    ones = np.ones(3, bool)
    prep = gpu.prepare(lam, mu, ones, gpu.empty_prep(3))
    whole, _ = gpu.run_chunk(trs, tols, ones, gpu.empty_state(3), prep, gpu.maxiter,
                             do_reset=True)
    state, _ = gpu.run_chunk(trs, tols, ones, gpu.empty_state(3), prep, 3, do_reset=True)
    after3, chunks = state, 1
    while bool(state.active.any()):
        state, _ = gpu.run_chunk(trs, tols, ~ones, state, prep, 3)
        chunks += 1
    chunked_equal = all(torch.equal(getattr(state, f.name), getattr(whole, f.name))
                        for f in dataclasses.fields(state))
    mask = np.array([False, True, False])
    lam2, mu2 = gpu.pack_materials([mats[0], {1: (9.0, 9.0), 2: (1.0, 3.0)}, mats[2]])
    prep2 = gpu.prepare(lam2, mu2, mask, prep)
    refilled, _ = gpu.run_chunk(trs, tols, mask, after3, prep2, 4, do_reset=True)
    untouched, _ = gpu.run_chunk(trs, tols, ~ones, after3, prep, 4)
    kept_equal = all(
        torch.equal(getattr(refilled, f.name)[[0, 2]], getattr(untouched, f.name)[[0, 2]])
        for f in dataclasses.fields(refilled))
    prep_kept = all(torch.equal(o.reshape(3, -1)[[0, 2]], n.reshape(3, -1)[[0, 2]])
                    for key in ("lam_w", "mu_w", "dinv", "lmax")
                    for o, n in zip(prep[key], prep2[key]))
    print(f"[small batched] {chunks} chunks of 3 == one chunk, bitwise: {chunked_equal}; "
          f"row 1 refilled, rows 0 and 2 of prep and state bitwise kept: "
          f"{prep_kept and kept_equal}")
    if not (chunked_equal and kept_equal and prep_kept):
        raise SystemExit("batched chunks or refill are not bitwise on the card")


def batched_phase() -> tuple[dict[str, tuple[int, int]], list[int]]:
    """The batched solve path (phase 5); returns the counted run's
    (launches, plain_calls) per kernel and its per-row iterations."""
    n_coarse = hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)[0].nscalar * 3
    t_setup0 = time.perf_counter()
    bsolver = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="f64",
                               device="cuda")
    fine = bsolver.fine_space
    mats, trs, tols = batched_scenarios()
    torch.cuda.synchronize()
    t_cold0 = time.perf_counter()
    cold = bsolver.solve(mats, trs, tols)
    torch.cuda.synchronize()
    t_cold1 = time.perf_counter()
    print(f"[batched] cold: setup {t_cold0 - t_setup0} s, solve {t_cold1 - t_cold0} s")
    # The same rows one solve_beam at a time, as they are served without the
    # batched solver: after one untimed warm-up call, each call timed on the
    # host clock between synchronize fences.  Rows 0 and 4 are held against
    # the batch.
    solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda", materials=mats[0],
               traction=tuple(trs[0]), rel_tol=float(tols[0]))
    seq_wall, seq_solve, seq_iters = [], [], []
    for row in range(BATCH_S):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one = solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda",
                         materials=mats[row], traction=tuple(trs[row]),
                         rel_tol=float(tols[row]), keep_solution=row in BATCH_CHECK_ROWS)
        torch.cuda.synchronize()
        seq_wall.append(time.perf_counter() - t)
        seq_solve.append(one.t_solve)
        seq_iters.append(one.iterations)
        if row in BATCH_CHECK_ROWS:
            scale = float(one.x.abs().max())
            rdiff = float((cold.x[row] - one.x).abs().max()) / scale
            print(f"[batched] row {row} vs solve_beam: iters {int(cold.iterations[row])}/"
                  f"{one.iterations}, max diff {rdiff:.3e} of max |x|")
            if int(cold.iterations[row]) != one.iterations or rdiff > 1e-10:
                raise SystemExit(f"batched row {row} disagrees with solve_beam")
        del one
    torch.cuda.empty_cache()
    print(f"[batched] one warm solve_beam a row: iters {seq_iters}, wall {seq_wall} s "
          f"(sum {sum(seq_wall)} s), t_solve sum {sum(seq_solve)} s")
    # The folded coarse probe (one apply of n * S rows) beside a loop over
    # the n identity columns (n applies of S rows), on the prepared level.
    lam, mu = bsolver.pack_materials(mats)
    prep = bsolver.prepare(lam, mu, np.ones(BATCH_S, bool), bsolver.empty_prep(BATCH_S))
    op0 = bsolver._base_ops[0].with_material_weights(prep["lam_w"][0], prep["mu_w"][0],
                                                     BATCH_S)
    cop0, n0 = op0.constrained(), n_coarse
    eye = torch.eye(n0, dtype=torch.float64, device="cuda")

    def probe_loop():
        return torch.stack([cop0(eye[j].reshape(1, -1, 3).expand(BATCH_S, -1, 3)
                                 .contiguous()).reshape(BATCH_S, n0)
                            for j in range(n0)], dim=2)

    probe_diff = float((probe_coarse_matrix(op0) - probe_loop()).abs().max())
    probe_t = event_ms({"folded": lambda: probe_coarse_matrix(op0), "loop": probe_loop},
                       n=3, rounds=3)
    print(f"[batched] coarse probe S={BATCH_S} n={n0}, in turns, median of 3 rounds of 3: "
          f"folded {probe_t['folded']} ms, column loop {probe_t['loop']} ms, max abs diff "
          f"{probe_diff:.3e}")
    del prep, lam, mu, op0, cop0, bsolver
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bsolver = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="f64",
                               device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lam, mu = bsolver.pack_materials(mats)
    ones = np.ones(BATCH_S, bool)
    prep = bsolver.prepare(lam, mu, ones, bsolver.empty_prep(BATCH_S))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, _ = bsolver.run_chunk(trs, tols, ones, bsolver.empty_state(BATCH_S), prep,
                                 bsolver.maxiter, do_reset=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    batch_counts = all_counts()
    batch_peak = torch.cuda.max_memory_allocated()
    t_setup, t_prepare, t_solve = t1 - t0, t2 - t1, t3 - t2
    rel = (torch.sqrt(state.nom.abs()) / torch.sqrt(state.nom0.abs())).tolist()
    converged = (state.nom <= state.threshold).tolist()
    ndof = fine.ndof
    print(f"[batched] p={MAIN_P} refine={MAIN_REFINE} f64 S={BATCH_S}: {ndof} DoFs a row, "
          f"{BATCH_S * fine.nelem} elements through the kernel at the fine level")
    print(f"[batched] iters {state.iters.tolist()}, converged {converged}, final rel norms "
          f"{rel}, rel_tol {tols.tolist()}")
    print(f"[batched] warm: setup {t_setup} s, prepare {t_prepare} s, solve {t_solve} s; "
          f"{BATCH_S / (t_prepare + t_solve)} scenarios/s (prepare + solve), "
          f"{ndof * BATCH_S / t_solve} DoF*rows/s (solve), peak memory "
          f"{batch_peak / 2**30:.3f} GiB")
    print(f"[batched] counts (launches, plain_calls): {batch_counts}")
    t_batch = t_setup + t_prepare + t_solve
    print(f"[batched] against one warm solve_beam a row, same run: {BATCH_S / t_batch} "
          f"against {BATCH_S / sum(seq_wall)} scenarios/s (setup + prepare + solve "
          f"{t_batch} s, summed wall {sum(seq_wall)} s: {sum(seq_wall) / t_batch}x); "
          f"t_solve {t_solve} s against summed t_solve {sum(seq_solve)} s: "
          f"{t_solve / sum(seq_solve)}x")
    if not all(converged):
        raise SystemExit("batched solve: a row did not converge")
    for name in ops.counts:
        launches, plain = batch_counts[name]
        if launches == 0 or plain != 0:
            raise SystemExit(f"batched path did not run only through {name}: "
                             f"launches={launches} plain_calls={plain}")
    if not (torch.equal(state.x, cold.x) and torch.equal(state.iters, cold.iterations)):
        raise SystemExit("batched warm run differs from the cold solve")
    if not bool(torch.isfinite(state.x).all()):
        raise SystemExit("batched solution is not finite")
    batch_iters = state.iters.tolist()
    del state, prep, lam, mu, cold
    torch.cuda.synchronize()
    ts0 = time.perf_counter()
    res, syncs = count_syncs(lambda: bsolver.solve(mats, trs, tols))
    torch.cuda.synchronize()
    print(f"[batched] solve() under sync debug mode: {syncs} host syncs, "
          f"{int(res.iterations.max())} iterations for the slowest row, "
          f"{time.perf_counter() - ts0} s")
    del res
    # The same prepare + run_chunk under torch.profiler: device busy share
    # of each phase (each ends in a synchronize).
    lam, mu = bsolver.pack_materials(mats)

    def profiled():
        with record_function("batched.prepare"):
            prep = bsolver.prepare(lam, mu, ones, bsolver.empty_prep(BATCH_S))
            torch.cuda.synchronize()
        with record_function("batched.pcg"):
            bsolver.run_chunk(trs, tols, ones, bsolver.empty_state(BATCH_S), prep,
                              bsolver.maxiter, do_reset=True)
            torch.cuda.synchronize()

    print_profile(profiled, prefix="batched.")
    del lam, mu, bsolver
    torch.cuda.empty_cache()
    return batch_counts, batch_iters


def service_requests() -> list:
    """SERVICE_N requests of the reference's serve_solve traffic at
    p=MAIN_P, refine=MAIN_REFINE: request i has the traction and rel_tol of
    request i of its ``make_workload``; requests 0-3 and 8-11 carry
    attribute dicts, 4-7 and 12-15 ``lognormal:SEED`` fields (12-15 repeat
    4-7, so prep rows are reused); 0-7 are phase 5's batch.  The requests
    of SERVICE_KEEP keep their solutions."""
    dicts = serve_workload(SERVICE_N, [MAIN_P], MAIN_REFINE, BATCH_BASE_TOL)
    fields = serve_workload(SERVICE_N, [MAIN_P], MAIN_REFINE, BATCH_BASE_TOL,
                            f"lognormal:{SEED}")
    return [dataclasses.replace((fields if (i // 4) % 2 else dicts)[i],
                                keep_solution=i in SERVICE_KEEP)
            for i in range(SERVICE_N)]


def service_run(svc: ElasticityService, reqs: list, continuous: bool):
    """One counted run of the service (every count zeroed just before,
    read just after), between synchronize fences: (reports, seconds,
    counts, stats delta, scheduler summary of this run's decisions,
    latency quantiles of this run's requests)."""
    stats0, n0 = dict(svc.stats), len(svc.trace.decisions)
    snap0 = svc.registry.snapshot()
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = svc.solve_continuous(reqs) if continuous else svc.solve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_counts()
    stats = {k: v - stats0[k] for k, v in svc.stats.items() if v != stats0[k]}
    run_trace = SchedulerTrace()
    for d in svc.trace.decisions[n0:]:
        run_trace.append(d)
    window = MetricsRegistry.from_snapshot(diff_snapshots(svc.registry.snapshot(), snap0))
    lat = window.merged_histogram("request_latency_seconds")
    latency = {f"p{round(q * 100)}": lat.quantile(q) for q in (0.5, 0.9, 0.99)}
    return reports, dt, counts, stats, run_trace.summary(), latency


def check_service_counts(tag: str, counts: dict, want_probe: bool) -> None:
    """The run went through the kernels alone: PAop launched (and the probe,
    where the run built a solver), no plain call."""
    for name in ops.counts:
        launches, plain = counts[name]
        if plain != 0 or (launches == 0 and (name == "pa_elasticity" or want_probe)):
            raise SystemExit(f"service {tag} run did not go only through {name}: "
                             f"launches={launches} plain_calls={plain}")


def check_same_as(tag: str, got: list, want: list) -> None:
    """Per request the same iterations and flags as ``want``, and kept
    solutions within 1e-10 of max |x|."""
    for g, w in zip(got, want, strict=True):
        if (g.iterations, g.converged, g.born_converged) != (w.iterations, w.converged,
                                                              w.born_converged):
            raise SystemExit(f"service {tag}: request {g.request} gave {g.iterations} "
                             f"iterations, converged {g.converged}; generational "
                             f"{w.iterations}, {w.converged}")
        if w.x is not None:
            scale = float(np.abs(w.x).max())
            diff = float(np.abs(g.x - w.x).max()) / scale
            if diff > 1e-10:
                raise SystemExit(f"service {tag}: a kept solution differs by {diff} of "
                                 f"max |x| from the generational run's")


def service_phase(batch_iters: list[int]) -> None:
    """The solve service (phase 5b) on one ElasticityService, so that its
    solver stays warm between runs (the chunk policy is swapped between
    them): the generational path, the continuous path under the fixed and
    the adaptive chunk policy (the adaptive run with host syncs counted),
    and a continuous run under torch.profiler with a fencing
    SpanRecorder."""
    t_phase = time.perf_counter()
    reqs = service_requests()
    svc = ElasticityService(max_batch=BATCH_S, precision="f64", chunk_iters=SERVICE_CHUNK,
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    gen, t_gen, counts, stats, _, latency = service_run(svc, reqs, continuous=False)
    t_setup = max(r.t_setup for r in gen)
    print(f"[service] p={MAIN_P} refine={MAIN_REFINE} f64, {SERVICE_N} requests, max_batch "
          f"{BATCH_S}, chunks of {SERVICE_CHUNK}; generational: iters "
          f"{[r.iterations for r in gen]}, {t_gen} s ({t_setup} s of it building the "
          f"solver), {SERVICE_N / (t_gen - t_setup)} scenarios/s without the build; "
          f"latency {latency}; counts {counts}; stats {stats}")
    check_service_counts("generational", counts, want_probe=True)
    if [r.iterations for r in gen[:BATCH_S]] != batch_iters:
        raise SystemExit(f"service generation 0 iterations {[r.iterations for r in gen[:BATCH_S]]}"
                         f" differ from phase 5's {batch_iters}")
    if not all(r.converged for r in gen):
        raise SystemExit("service generational: a request did not converge")
    t_gen_solve = t_gen - t_setup

    for policy in ("fixed", "adaptive"):
        svc.chunk_policy = make_chunk_policy(policy, chunk_iters=SERVICE_CHUNK)
        if policy == "adaptive":
            out, syncs = count_syncs(lambda: service_run(svc, reqs, continuous=True))
        else:
            out, syncs = service_run(svc, reqs, continuous=True), None
        cont, t_cont, counts, stats, sched, latency = out
        check_service_counts(f"continuous {policy}", counts, want_probe=False)
        check_same_as(f"continuous {policy}", cont, gen)
        print(f"[service] continuous {policy}: {t_cont} s, {SERVICE_N / t_cont} scenarios/s "
              f"({t_gen_solve / t_cont}x generational); latency {latency}; counts {counts}")
        print(f"[service] scheduler[{policy}]: chunks={sched['chunks']} mean_chunk="
              f"{sched['mean_chunk']} wasted_iters={sched['wasted_iters']} refills="
              f"{sched['refills']}; stats {stats}")
        if syncs is not None:
            print(f"[service] continuous {policy} under sync debug mode: {syncs} host syncs "
                  f"in {sched['chunks']} steps, {syncs / sched['chunks']} a step")
    print(f"[service] latency_summary() over the three runs: {svc.latency_summary()}")
    print(f"[service] peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    frozen = sum(max(r.iterations for r in gen[g:g + BATCH_S]) * BATCH_S
                 - sum(r.iterations for r in gen[g:g + BATCH_S])
                 for g in range(0, SERVICE_N, BATCH_S))
    print(f"[service] generational frozen row-iterations {frozen} of "
          f"{sum(r.iterations for r in gen) + frozen}")

    # A last fixed-policy run under torch.profiler, with a fencing span
    # recorder attached: the device's busy share, and the lifecycle spans.
    svc.chunk_policy = make_chunk_policy("fixed", chunk_iters=SERVICE_CHUNK)
    rec = SpanRecorder(fence=True)
    svc.attach_spans(rec)
    runs = []

    def profiled():
        with record_function("service.continuous"):
            runs.append(service_run(svc, reqs, continuous=True))

    t_prof = time.perf_counter()
    print_profile(profiled, prefix="service.", top=12)
    t_prof = time.perf_counter() - t_prof
    fenced, t_fenced, counts, _, _, _ = runs[0]
    check_service_counts("fenced", counts, want_probe=False)
    check_same_as("fenced", fenced, gen)
    waits = {s.args["ticket"]: s for s in rec.by_name("queue_wait")}
    worst = 0.0
    for sp in rec.by_name("solve"):
        a = sp.args
        wall = sp.end - waits[a["ticket"]].start
        worst = max(worst, abs(a["queue_wait"] + a["compute"] + a["overhead"] - wall))
    if len(rec.by_name("solve")) != SERVICE_N or worst > 1e-9:
        raise SystemExit(f"service spans: {len(rec.by_name('solve'))} solve spans, lifecycle "
                         f"identity off by {worst} s")
    span_sum = {name: sum(sp.duration for sp in rec.by_name(name))
                for name in ("chunk_dispatch", "chunk_device", "prep", "step")}
    trace_dir = tempfile.mkdtemp(prefix="service_trace_")
    rec.to_chrome_trace(os.path.join(trace_dir, "service.json"))
    shutil.rmtree(trace_dir)
    print(f"[service] profiled, fenced continuous run: {t_fenced} s ({t_prof} s with the "
          f"profile's processing), {rec.count()} spans, summed seconds {span_sum}; "
          f"queue_wait + compute + overhead == wall per ticket to {worst} s; Chrome trace "
          f"written to a temporary directory")
    print(f"[service] phase wall {time.perf_counter() - t_phase} s")
    del svc, gen, fenced, runs
    torch.cuda.empty_cache()


def small_service_check() -> None:
    """p=2, refine=1, 6 requests, max_batch 4, continuous (chunks of 3) on
    the card and on the CPU from the same start vectors: iterations and
    flags equal, solutions within 1e-10 of max |x|."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    reqs = [dataclasses.replace(r, keep_solution=True)
            for r in serve_workload(6, [2], 1, BATCH_BASE_TOL, f"lognormal:{SEED}")[:3]
            + serve_workload(6, [2], 1, BATCH_BASE_TOL)[3:]]
    inner = elasticity_service.BatchedGMGSolver
    elasticity_service.BatchedGMGSolver = functools.partial(inner, start_vectors=sv)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            svc = ElasticityService(max_batch=4, chunk_iters=3, device=dev)
            reset_all_counts()
            out[dev] = svc.solve_continuous(reqs)
            if dev == "cuda":
                check_service_counts("small", all_counts(), want_probe=True)
    finally:
        elasticity_service.BatchedGMGSolver = inner
    diff = max(float(np.abs(a.x - b.x).max() / np.abs(b.x).max())
               for a, b in zip(out["cuda"], out["cpu"]))
    print(f"[small service] p=2 refine=1, 6 requests, max_batch 4, continuous: iters card/cpu "
          f"{[r.iterations for r in out['cuda']]}/{[r.iterations for r in out['cpu']]}, "
          f"max rel diff {diff:.3e}")
    if [(r.iterations, r.converged) for r in out["cuda"]] != \
            [(r.iterations, r.converged) for r in out["cpu"]] or diff > 1e-10 \
            or not all(r.converged for r in out["cpu"]):
        raise SystemExit("small service on the card disagrees with the CPU")


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
    n_coarse = hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)[0].nscalar * 3
    cases += [(torch.float64, p, BATCH_S * ne) for p, ne in main_shapes]
    cases.append((torch.float64, 1, n_coarse * BATCH_S * main_shapes[0][1]))
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

    # ---- 5. the batched solve path, counted
    batch_counts, batch_iters = batched_phase()
    small_batched_check()
    torch.cuda.empty_cache()

    # ---- 5b. the solve service, counted
    service_phase(batch_iters)
    small_service_check()
    torch.cuda.empty_cache()

    # ---- 6. the serve path, counted: qwen3-1.7b at full width, bf16
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

    # ---- 7. time the PAop apply (kernel, baseline, plain) and the flash kernel
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
