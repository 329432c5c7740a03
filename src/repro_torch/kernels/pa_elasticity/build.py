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
SOURCES = ("pa_elasticity.cu", "pa_elasticity_baseline.cu", "probe.cu")

_P = ctypes.c_void_p


class KernelLibrary:
    """The loaded shared library with its C signatures declared."""

    def __init__(self, path: pathlib.Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from _build/
        self.log = log  # nvcc/ptxas output of the build (registers, spills)
        lib = ctypes.CDLL(str(path))
        # The C entry points, looked up once: PAop and its baseline (the
        # first port's kernel, a yardstick) by dtype, their launch shapes,
        # the probe.
        self.pa_elasticity, self.pa_elasticity_baseline, self._config = {}, {}, {}
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            for name, table in (("pa_elasticity", self.pa_elasticity),
                                ("pa_elasticity_baseline", self.pa_elasticity_baseline)):
                fn = getattr(lib, f"{name}_{tag}")
                fn.argtypes = [_P] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
                fn.restype = ctypes.c_int
                table[dtype] = fn
                cfg = getattr(lib, f"{name}_config_{tag}")
                cfg.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
                cfg.restype = ctypes.c_int
                self._config[name, dtype] = cfg
        lib.probe_f32.argtypes = [_P, _P, ctypes.c_int, _P]
        lib.probe_f32.restype = ctypes.c_int
        self.probe = lib.probe_f32
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")

    def config(self, name: str, dtype, d1d: int) -> dict[str, int]:
        """Launch shape of kernel ``name`` ("pa_elasticity" or
        "pa_elasticity_baseline") at (dtype, D1D) and its resident blocks
        per SM on the current card."""
        out = [ctypes.c_int() for _ in range(4)]
        self.check(self._config[name, dtype](d1d, *map(ctypes.byref, out)),
                   f"{name} config (D1D={d1d}, {dtype})")
        keys = ("threads", "elems", "smem_bytes", "blocks_per_sm")
        return {k: v.value for k, v in zip(keys, out)}

    def probe_check(self) -> None:
        """Launch the probe once on the current card and compare it with
        ``2 * x``."""
        x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
        o = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(
            self.probe(x.data_ptr(), o.data_ptr(), x.numel(), stream),
            "probe kernel launch",
        )
        if not torch.equal(o, 2 * x):
            raise RuntimeError("probe kernel returned a wrong result")


_LOCK = threading.Lock()
_LOADED: list[KernelLibrary] = []


def load() -> KernelLibrary:
    """Build (if needed), load and probe the kernel library, once per
    process.  Once it is loaded, a call returns it without the lock."""
    if _LOADED:
        return _LOADED[0]
    with _LOCK:
        if not _LOADED:
            path, seconds, text = nvcc.build(CSRC, SOURCES, BUILD_DIR, "pa_elasticity")
            lib = KernelLibrary(path, seconds, text)
            lib.probe_check()
            _LOADED.append(lib)
        return _LOADED[0]
