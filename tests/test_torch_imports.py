"""The port stands alone: it imports torch, numpy and scipy, never jax
and nothing of the reference package ``repro``."""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_no_reference_import_statements():
    offenders = [
        str(f.relative_to(ROOT)) for f in PORT_FILES if FORBIDDEN.search(f.read_text())
    ]
    assert not offenders, offenders


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(ROOT / "src")!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 25, names
        print("ok", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
