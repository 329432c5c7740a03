"""Build and load the flash-attention kernel library.

``csrc/flash_attention.cu`` (the mma_sync and fma routes of the forward),
``csrc/flash_attention_wgmma.cu`` (its wgmma route),
``csrc/flash_attention_bwd.cu`` (the backward's mma_sync and fma routes and
its delta pass) and ``csrc/flash_attention_bwd_wgmma.cu`` (the backward's
wgmma route) are compiled at first use with ``nvcc`` for ``sm_90a``, one
process each, into one shared library with a plain C interface, loaded with
``ctypes``; :mod:`repro_torch.kernels.nvcc` does the build into ``_build/``
beside this file, named by a hash of ``csrc/`` and the flags.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

from repro_torch.kernels import nvcc

__all__ = ["KernelLibrary", "load", "BUILD_DIR", "SOURCES", "ENTRY_POINTS",
           "LSE_ENTRY_POINTS", "BWD_ENTRY_POINTS"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention.cu", "flash_attention_wgmma.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_wgmma.cu")
# (route, dtype name) -> C entry point of the forward, without and with the
# LSE output, and of the backward
ENTRY_POINTS = {
    ("wgmma", "bf16"): "flash_attention_wgmma_bf16",
    ("mma_sync", "bf16"): "flash_attention_mma_sync_bf16",
    ("fma", "bf16"): "flash_attention_fma_bf16",
    ("fma", "f32"): "flash_attention_fma_f32",
}
LSE_ENTRY_POINTS = {
    ("wgmma", "bf16"): "flash_attention_wgmma_lse_bf16",
    ("mma_sync", "bf16"): "flash_attention_mma_sync_lse_bf16",
    ("fma", "bf16"): "flash_attention_fma_lse_bf16",
    ("fma", "f32"): "flash_attention_fma_lse_f32",
}
BWD_ENTRY_POINTS = {
    ("wgmma", "bf16"): "flash_attention_bwd_wgmma_bf16",
    ("mma_sync", "bf16"): "flash_attention_bwd_bf16",
    ("fma", "f32"): "flash_attention_bwd_f32",
}

_P = ctypes.c_void_p
# q, k, v, o; B, S, H, K, D, window; (b, s, h) strides of q, k, v, o; stream
_ARGTYPES = [_P] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 + [_P]
# the same, then the LSE buffer before the stream
_LSE_ARGTYPES = _ARGTYPES[:-1] + [_P, _P]
# q, k, v, o, dO, dq, dk, dv, lse, delta scratch; B, S, H, K, D, window;
# (b, s, h) strides of q, k, v, o, dO, dq, dk, dv; stream
_BWD_ARGTYPES = [_P] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 24 + [_P]


class KernelLibrary:
    """The loaded shared library with its C signatures declared."""

    def __init__(self, path: pathlib.Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from _build/
        self.log = log  # nvcc/ptxas output of the build (registers, spills)
        lib = ctypes.CDLL(str(path))
        for table, argtypes in ((ENTRY_POINTS, _ARGTYPES), (LSE_ENTRY_POINTS, _LSE_ARGTYPES),
                                (BWD_ENTRY_POINTS, _BWD_ARGTYPES)):
            for name in table.values():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.flash_attention_wgmma_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_wgmma_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_bwd_wgmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_attention_bwd_wgmma_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.flash_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


_LOCK = threading.Lock()
_LOADED: list[KernelLibrary] = []


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    with _LOCK:
        if not _LOADED:
            _LOADED.append(KernelLibrary(*nvcc.build(CSRC, SOURCES, BUILD_DIR, "flash_attention")))
        return _LOADED[0]
