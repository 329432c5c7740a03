"""Build a kernel package's CUDA sources into a plain-C shared library.

Every kernel package of the port keeps its sources in ``csrc/`` and is
bound to PyTorch through ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes).  :func:`build` compiles each source in its own
``nvcc`` process for ``sm_90a``, all started together, then links once.
The library lands in the package's ``_build/`` (listed in ``.gitignore``),
named by a hash of every file under ``csrc/`` (headers included) and of the
flags, so an edited source or header rebuilds and an unchanged tree loads
at once.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["ARCH", "FLAGS", "build", "nvcc_path"]

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _digest(csrc: pathlib.Path, sources: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode())
        h.update(path.read_bytes())
    h.update("\0".join(sources).encode())
    h.update("\0".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd: list[str], log: pathlib.Path) -> subprocess.Popen:
    with open(log, "w") as f:
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)


def _compile(csrc: pathlib.Path, sources: tuple[str, ...], target: pathlib.Path) -> str:
    nvcc = nvcc_path()
    tmp = pathlib.Path(tempfile.mkdtemp(dir=target.parent))
    try:
        objs, jobs = [], []
        for name in sources:
            obj = tmp / (name + ".o")
            log = tmp / (name + ".log")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(csrc / name), "-o", str(obj)]
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


def build(
    csrc: pathlib.Path, sources: tuple[str, ...], build_dir: pathlib.Path, stem: str
) -> tuple[pathlib.Path, float, str]:
    """``(library path, build seconds, nvcc/ptxas log)`` of
    ``build_dir/lib{stem}-{hash}.so``; the seconds are 0.0 when the library
    was already built."""
    build_dir.mkdir(parents=True, exist_ok=True)
    target = build_dir / f"lib{stem}-{_digest(csrc, sources)}.so"
    if target.exists():
        log = target.with_suffix(".log")
        return target, 0.0, log.read_text() if log.exists() else ""
    t0 = time.perf_counter()
    text = _compile(csrc, sources, target)
    return target, time.perf_counter() - t0, text
