"""Port's PAop kernel wrapper vs the reference Pallas kernel.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is
held against the reference's Pallas kernel in interpret mode and against
the reference's oracle ``paop_ref`` for p = 1..8, NE in {1, 5, 7}, an
identity and a sheared (non-diagonal) J^{-1}, in float64 (rtol 1e-12) and
float32 (rtol 2e-4, docs/KERNELS.md).  The reference kernel runs once per
(p, dtype) at NE = 7; elements are independent, so NE = 1 and 5 compare
against its leading rows.

The CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pa_elasticity import ops as ref_ops
from repro.kernels.pa_elasticity.ref import paop_ref as ref_paop_ref
from repro_torch.core.basis import basis_tables
from repro_torch.kernels import nvcc
from repro_torch.kernels.pa_elasticity import build, ops
from repro_torch.kernels.pa_elasticity.ref import paop_ref

NE_MAX = 7
# Sheared box: J = A diag(h/2), J^{-1} non-diagonal.
LINEAR_MAP = np.array([[1.0, 0.2, 0.1], [0.05, 1.0, 0.3], [0.1, 0.0, 1.0]])
JINV = {
    "identity": np.eye(3),
    "linear_map": np.linalg.inv(LINEAR_MAP @ np.diag([0.25, 0.5, 0.5])),
}
TOL = {"f64": (1e-12, 1e-12), "f32": (2e-4, 2e-5)}  # rtol, atol / max|ref|
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _inputs(p, dtype_name, jinv_name):
    tb = basis_tables(p)
    rng = np.random.default_rng(100 + p)
    npdt, _ = DTYPES[dtype_name]
    d, q = tb.d1d, tb.q1d
    return tuple(
        a.astype(npdt)
        for a in (
            rng.standard_normal((NE_MAX, 3, d, d, d)),
            rng.random((NE_MAX, q, q, q)) + 0.5,
            rng.random((NE_MAX, q, q, q)) + 0.5,
            JINV[jinv_name],
            tb.B,
            tb.G,
        )
    )


_ref_oracle = jax.jit(ref_paop_ref)


@functools.lru_cache(maxsize=None)
def _reference(p, dtype_name, jinv_name):
    """(interpret-mode Pallas kernel, oracle) outputs at NE = 7."""
    args = [jnp.asarray(a) for a in _inputs(p, dtype_name, jinv_name)]
    y_kernel = ref_ops.pa_elasticity(*args, interpret=True)
    y_oracle = _ref_oracle(*args)
    return np.asarray(y_kernel), np.asarray(y_oracle)


@pytest.mark.parametrize("jinv_name", sorted(JINV))
@pytest.mark.parametrize("ne", [1, 5, 7])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("p", range(1, 9))
def test_wrapper_matches_reference_kernel(p, dtype_name, ne, jinv_name):
    _, tdt = DTYPES[dtype_name]
    args = [torch.from_numpy(a) for a in _inputs(p, dtype_name, jinv_name)]
    args[0], args[1], args[2] = args[0][:ne], args[1][:ne], args[2][:ne]
    before = (ops.counts["pa_elasticity"].launches, ops.counts["pa_elasticity"].plain_calls)
    y = ops.pa_elasticity(*args)
    after = (ops.counts["pa_elasticity"].launches, ops.counts["pa_elasticity"].plain_calls)
    assert after == (before[0], before[1] + 1)  # the plain version ran
    assert y.dtype == tdt and y.shape == args[0].shape
    rtol, atol = TOL[dtype_name]
    for ref in _reference(p, dtype_name, jinv_name):
        ref = ref[:ne]
        np.testing.assert_allclose(
            y.numpy(), ref, rtol=rtol, atol=atol * np.abs(ref).max()
        )


def _small_args(p=2, ne=3, dtype=torch.float64):
    tb = basis_tables(p)
    g = torch.Generator().manual_seed(0)
    d, q = tb.d1d, tb.q1d
    return [
        torch.randn((ne, 3, d, d, d), generator=g, dtype=dtype),
        torch.rand((ne, q, q, q), generator=g, dtype=dtype) + 0.5,
        torch.rand((ne, q, q, q), generator=g, dtype=dtype) + 0.5,
        torch.eye(3, dtype=dtype),
        torch.as_tensor(tb.B, dtype=dtype),
        torch.as_tensor(tb.G, dtype=dtype),
    ]


def test_cpu_call_counts_plain_not_launches():
    ops.reset_counts()
    ops.pa_elasticity(*_small_args())
    ops.probe(torch.ones(8, 128))
    assert ops.counts["pa_elasticity"].launches == 0
    assert ops.counts["pa_elasticity"].plain_calls == 1
    assert (ops.counts["probe"].launches, ops.counts["probe"].plain_calls) == (0, 1)
    ops.reset_counts()
    assert ops.counts["pa_elasticity"].plain_calls == 0


def test_plain_version_is_paop_ref():
    args = _small_args(p=3, ne=4)
    torch.testing.assert_close(ops.pa_elasticity(*args), paop_ref(*args), rtol=0, atol=0)


def _bad(kind):
    args = _small_args()
    if kind == "x_rank":
        args[0] = args[0][:, 0].contiguous()
    elif kind == "lam_elems":
        args[1] = args[1][:2].contiguous()
    elif kind == "per_element_jinv":
        args[3] = torch.eye(3, dtype=torch.float64).expand(3, 3, 3).contiguous()
    elif kind == "q1d":
        tb = basis_tables(2, q1d=5)
        args[1] = torch.rand((3, 5, 5, 5), dtype=torch.float64)
        args[2] = args[1].clone()
        args[4] = torch.as_tensor(tb.B)
        args[5] = torch.as_tensor(tb.G)
    elif kind == "p9":
        tb = basis_tables(9)
        args = [torch.zeros((2, 3, 10, 10, 10), dtype=torch.float64),
                torch.zeros((2, 11, 11, 11), dtype=torch.float64),
                torch.zeros((2, 11, 11, 11), dtype=torch.float64),
                torch.eye(3, dtype=torch.float64),
                torch.as_tensor(tb.B), torch.as_tensor(tb.G)]
    elif kind == "bf16":
        args = [a.to(torch.bfloat16) for a in args]
    elif kind == "mixed_dtype":
        args[1] = args[1].float()
    elif kind == "noncontiguous":
        args[0] = args[0].transpose(2, 4)
    return args


@pytest.mark.parametrize(
    "kind,match",
    [
        ("x_rank", "x_e has shape"),
        ("lam_elems", "lam_w"),
        ("per_element_jinv", "mesh-constant"),
        ("q1d", r"\(D1D, Q1D\) = \(3, 5\)"),
        ("p9", r"\(D1D, Q1D\) = \(10, 11\)"),
        ("bf16", "bfloat16"),
        ("mixed_dtype", "lam_w is torch.float32"),
        ("noncontiguous", "contiguous"),
    ],
)
def test_wrapper_rejects(kind, match):
    with pytest.raises(ValueError, match=match):
        ops.pa_elasticity(*_bad(kind))


def test_probe_rejects_non_f32():
    with pytest.raises(ValueError, match="float32"):
        ops.probe(torch.ones(4, dtype=torch.float64))



def test_launch_baseline_refuses_cpu_tensors():
    before = (ops.counts["pa_elasticity"].launches, ops.counts["pa_elasticity"].plain_calls)
    with pytest.raises(ValueError, match="only on CUDA tensors"):
        ops.launch_baseline(*_small_args())
    after = (ops.counts["pa_elasticity"].launches, ops.counts["pa_elasticity"].plain_calls)
    assert after == before


def test_launch_baseline_checks_arguments():
    with pytest.raises(ValueError, match="x_e has shape"):
        ops.launch_baseline(*_bad("x_rank"))


def test_load_fast_path_builds_once(monkeypatch):
    calls = []

    def fake_build(csrc, sources, build_dir, stem):
        calls.append(stem)
        return build_dir / "libfake.so", 0.0, ""

    class FakeLibrary:
        def __init__(self, path, seconds, log):
            self.path = path

        def probe_check(self):
            pass

    monkeypatch.setattr(build.nvcc, "build", fake_build)
    monkeypatch.setattr(build, "KernelLibrary", FakeLibrary)
    monkeypatch.setattr(build, "_LOADED", [])
    first = build.load()
    assert build.load() is first and build.load() is first
    assert calls == ["pa_elasticity"]


def test_sources_hash_covers_the_baseline(tmp_path):
    assert "pa_elasticity_baseline.cu" in build.SOURCES
    for name in build.SOURCES:
        assert (build.CSRC / name).is_file()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in build.SOURCES:
        (csrc / name).write_bytes((build.CSRC / name).read_bytes())
    before = nvcc._digest(csrc, build.SOURCES)
    path = csrc / "pa_elasticity_baseline.cu"
    path.write_text(path.read_text() + "\n// edited\n")
    assert nvcc._digest(csrc, build.SOURCES) != before
