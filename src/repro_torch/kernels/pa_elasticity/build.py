"""Build and load the CUDA kernels of this package.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Each source compiles in its own ``nvcc`` process, all started together,
then one link.  The library lands in ``_build/`` beside this file (listed
in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.

After each load the probe kernel (``o = 2 x``) runs once on the current
card and is compared with ``2 * x``: a toolchain or launch fault raises
here, before any solve starts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

__all__ = ["KernelLibrary", "load", "nvcc_path", "BUILD_DIR", "SOURCES"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("pa_elasticity.cu", "probe.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use"
    )


class KernelLibrary:
    """The loaded shared library with its C signatures declared."""

    def __init__(self, path: pathlib.Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from _build/
        self.log = log  # nvcc/ptxas output of the build (registers, spills)
        lib = ctypes.CDLL(str(path))
        for name in ("pa_elasticity_f64", "pa_elasticity_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.probe_f32.argtypes = [_P, _P, ctypes.c_int, _P]
        lib.probe_f32.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")

    def probe_check(self) -> None:
        """Launch the probe once on the current card and compare it with
        ``2 * x``."""
        x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
        o = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(
            self.lib.probe_f32(x.data_ptr(), o.data_ptr(), x.numel(), stream),
            "probe kernel launch",
        )
        if not torch.equal(o, 2 * x):
            raise RuntimeError("probe kernel returned a wrong result")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd: list[str], log: pathlib.Path) -> subprocess.Popen:
    with open(log, "w") as f:
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)


def _build(target: pathlib.Path) -> str:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs, jobs = [], []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            log = tmp / (name + ".log")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            jobs.append((name, _run(cmd, log), log))
            objs.append(str(obj))
        out = []
        for name, proc, log in jobs:
            proc.wait()
            out.append(f"== {name}\n{log.read_text()}")
        failed = [name for name, proc, _ in jobs if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(out))
        lib = tmp / target.name
        link_log = tmp / "link.log"
        link = _run([nvcc, *ARCH, "-shared", "-o", str(lib), *objs], link_log)
        if link.wait() != 0:
            raise RuntimeError(f"nvcc link failed:\n{link_log.read_text()}")
        text = "\n".join(out)
        target.with_suffix(".log").write_text(text)
        os.replace(lib, target)
        return text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_LOCK = threading.Lock()
_LOADED: list[KernelLibrary] = []


def load() -> KernelLibrary:
    """Build (if needed), load and probe the kernel library, once per
    process."""
    with _LOCK:
        if not _LOADED:
            target = BUILD_DIR / f"libpa_elasticity-{_digest()}.so"
            t0 = time.perf_counter()
            if target.exists():
                log = target.with_suffix(".log")
                text = log.read_text() if log.exists() else ""
                seconds = 0.0
            else:
                text = _build(target)
                seconds = time.perf_counter() - t0
            lib = KernelLibrary(target, seconds, text)
            lib.probe_check()
            _LOADED.append(lib)
        return _LOADED[0]
