"""Build and load the CUDA kernels of this package.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``; :mod:`repro_torch.kernels.nvcc` does the build (one ``nvcc``
per source, all started together, then one link) into ``_build/`` beside
this file, named by a hash of the sources and flags.

After each load the probe kernel (``o = 2 x``) runs once on the current
card and is compared with ``2 * x``: a toolchain or launch fault raises
here, before any solve starts.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import nvcc

__all__ = ["KernelLibrary", "load", "BUILD_DIR", "SOURCES"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("pa_elasticity.cu", "probe.cu")

_P = ctypes.c_void_p


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


_LOCK = threading.Lock()
_LOADED: list[KernelLibrary] = []


def load() -> KernelLibrary:
    """Build (if needed), load and probe the kernel library, once per
    process."""
    with _LOCK:
        if not _LOADED:
            path, seconds, text = nvcc.build(CSRC, SOURCES, BUILD_DIR, "pa_elasticity")
            lib = KernelLibrary(path, seconds, text)
            lib.probe_check()
            _LOADED.append(lib)
        return _LOADED[0]
