"""Time variants of the PAop kernel's launch configuration against each
other and the baseline kernel, in turns, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.pa_elasticity.tune [--p 4] [--ne 32768]

Each variant is this checkout's ``csrc/`` with a few constants of
``pa_elasticity.cu`` replaced (threads a quadrature column, elements per
block, components per sweep), built into a library of
its own in ``_build/`` (all variants' ``nvcc`` runs at once).  Every
variant is first held against the plain version at the timed shape (f64,
rtol and atol 1e-12 of max |plain|, as in ``chip_smoke.py``); then each
runs in rounds of 10 back-to-back launches between one pair of CUDA
events, the variants in turns, and the median round is printed with what
``ptxas`` and the occupancy query say about it.  The card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import re
import shutil
import statistics
import subprocess

import torch

from repro_torch.core.basis import basis_tables
from repro_torch.kernels import nvcc
from repro_torch.kernels.pa_elasticity import build
from repro_torch.kernels.pa_elasticity.ref import paop_ref

# name -> list of (pattern, replacement) applied to pa_elasticity.cu
SPLIT = r"static constexpr int kSplit = D >= 8 \? 2 : 1;"
VARIANTS = {
    "as built": [],
    "two threads a column at every p": [(SPLIT, "static constexpr int kSplit = 2;")],
    "one thread a column at every p": [
        (SPLIT, "static constexpr int kSplit = 1;"),
        (r"\(kSplit == 1 \? 168 : 128\)", "(D == 9 ? 255 : 168)")],
    "2 elements at p = 3, 4 (96 threads)": [
        (r"d == 3 \? 8 : d <= 5 \? 3 : 1", "d == 3 ? 8 : d <= 5 ? 2 : 1")],
    "one component a sweep": [(r"static constexpr int kGroup = [^;]*;",
                               "static constexpr int kGroup = 1;")],
    "three components a sweep at every p": [(r"static constexpr int kGroup = [^;]*;",
                                             "static constexpr int kGroup = 3;")],
}


def _variant_csrc(name: str, subs):
    out = build.BUILD_DIR / "tune" / re.sub(r"\W+", "_", name) / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(build.CSRC, out)
    path = out / "pa_elasticity.cu"
    text = path.read_text()
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise RuntimeError(f"variant {name!r}: {pattern!r} not found in pa_elasticity.cu")
    path.write_text(text)
    return out


def _ptxas(log: str, d1d: int) -> str:
    """Registers and spills ptxas reports for the f64 PAop kernel at D1D."""
    inside, spill = False, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = f"pa_elasticity_kernelIdLi{d1d}E" in line
        elif inside and "spill stores" in line:
            spill = line.strip()
        elif inside and "Used" in line:
            return f"{line.split('Used', 1)[1].strip()}; {spill}"
    return "not found"


def _inputs(p: int, ne: int):
    tb = basis_tables(p)
    g = torch.Generator(device="cuda").manual_seed(0)
    d, q = tb.d1d, tb.q1d
    f64 = dict(dtype=torch.float64, device="cuda")
    jinv = torch.diag(torch.tensor([2.0, 3.0, 4.0], **f64))
    return (torch.randn((ne, 3, d, d, d), generator=g, **f64),
            torch.rand((ne, q, q, q), generator=g, **f64) + 0.5,
            torch.rand((ne, q, q, q), generator=g, **f64) + 0.5,
            jinv + 0.1 * torch.randn((3, 3), generator=g, **f64),
            torch.as_tensor(tb.B, **f64), torch.as_tensor(tb.G, **f64))


def _launcher(fn, args):
    x = args[0]
    ne, d1d, q1d = x.shape[0], x.shape[-1], args[1].shape[-1]
    ptrs = [a.data_ptr() for a in args]

    def run():
        y = torch.empty_like(x)
        err = fn(*ptrs, y.data_ptr(), ne, d1d, q1d, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y
    return run


def _round_ms(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--ne", type=int, default=32768)
    ap.add_argument("--rounds", type=int, default=7)
    args_ = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dirs = {name: _variant_csrc(name, subs) for name, subs in VARIANTS.items()}
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        built = {name: pool.submit(nvcc.build, d, build.SOURCES, d.parent / "_build",
                                   "pa_elasticity") for name, d in dirs.items()}
        libs = {name: build.KernelLibrary(*f.result()) for name, f in built.items()}
    args = _inputs(args_.p, args_.ne)
    ref = paop_ref(*args)
    scale = float(ref.abs().max())
    fns = {}
    for name, kl in libs.items():
        fns[name] = _launcher(kl.pa_elasticity[torch.float64], args)
        err = float((fns[name]() - ref).abs().max()) / scale
        cfg = kl.config("pa_elasticity", torch.float64, args_.p + 1)
        print(f"[variant] {name}: max rel err {err:.3e}, {cfg}, ptxas: "
              f"{_ptxas(kl.log, args_.p + 1)}")
        if err > 1e-12:
            raise SystemExit(f"variant {name!r} disagrees with the plain version: {err}")
    fns["baseline"] = _launcher(libs["as built"].pa_elasticity_baseline[torch.float64], args)
    del ref
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(args_.rounds):
        for name, fn in fns.items():
            times[name].append(_round_ms(fn, 10))
    for name, t in times.items():
        print(f"[tune] p={args_.p} NE={args_.ne} f64 {name}: {statistics.median(t)} ms "
              f"(median of {args_.rounds} rounds of 10, in turns)")


if __name__ == "__main__":
    main()
