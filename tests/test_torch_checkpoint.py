"""The port's checkpoint manager (``repro_torch.checkpoint.manager``) and
the batched solver's host (de)serialization, against the reference's.

* the reference's ``tests/test_checkpoint.py`` cases, on the port;
* each package's manager reads the other's checkpoints: same manifest
  paths, shapes, dtypes, crc32 and ``extra``;
* ``state_to_host``/``prep_to_host`` of the port and of the reference on
  the same inputs, mid-solve: same names, shapes and dtypes, and values
  within 1e-12 of max |.| in f64;
* a checkpoint the reference wrote mid-solve resumes in the port to the
  reference's iterations and solution.

The solver cases run at p=1, refine=1: at refine 0 the hierarchy is the
exact coarse solve alone, every row converges in one iteration and its
residual is rounding noise, so there is no mid-solve state to compare."""

from __future__ import annotations

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.fem.mesh import beam_hex as ref_beam_hex
from repro.solvers.batched import BatchedGMGSolver as RefBatchedGMGSolver
from repro_torch.checkpoint.manager import CheckpointManager, _flatten_with_paths
from repro_torch.core.precision import resolve_precision
from repro_torch.fem.mesh import beam_hex
from repro_torch.solvers.batched import BatchedGMGSolver

from tests.test_torch_service import ref_start_solver

MATS = [{1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (9.0, 9.0), 2: (1.0, 3.0)}]
TRACTIONS = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2]])
REL_TOL = 1e-10


def _items(x=1.0):
    """A serving-style flat snapshot: solver array leaves + one pickled
    host blob (the layout ServiceRecovery writes)."""
    blob = {"queue": [(0, "req")], "next_ticket": 3, "scale": x}
    return {
        "flight0/state/x": np.full((4, 3), x),
        "flight0/state/iters": np.asarray([2, 5, 0, 1], np.int32),
        "flight0/state/active": np.asarray([True, False, True, False]),
        "flight0/prep/chol": np.full((4, 6), 0.5 * x),
        "host": np.frombuffer(pickle.dumps(blob), dtype=np.uint8),
    }


def _assert_items_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k


# -- the reference's manager cases, on the port ------------------------------
def test_save_restore_items_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    items = _items(2.5)
    mgr.save(10, items, extra={"format": 1, "devices": 1})
    got, extra = mgr.restore_items()
    _assert_items_equal(got, items)
    assert extra == {"format": 1, "devices": 1}
    blob = pickle.loads(got["host"].tobytes())
    assert blob["next_ticket"] == 3 and blob["scale"] == 2.5
    assert mgr.latest() == 10


def test_restore_items_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore_items()
    assert mgr.restore_latest_items() is None


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _items(float(s)))
    assert mgr.available_steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _items())
    broken = tmp_path / "step_000000009"  # a crash mid-write: no manifest
    broken.mkdir()
    (broken / "leaf_00000.npy").write_bytes(b"junk")
    assert mgr.latest() == 5
    _, _, step = mgr.restore_latest_items()
    assert step == 5


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _items(1.0))
    mgr.save(2, _items(2.0))
    leaf = tmp_path / "step_000000002" / "leaf_00000.npy"
    np.save(leaf, np.load(leaf) + 999)
    with pytest.raises(IOError, match="crc"):
        mgr.restore_items(2)
    got, _, step = mgr.restore_latest_items()
    assert step == 1
    _assert_items_equal(got, _items(1.0))


def test_restore_casts_dtype(tmp_path):
    """restore-with-``like`` casts to the like leaf's dtype (a torch
    tensor like gives a torch tensor of its dtype)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((2, 2), dtype=torch.float32)})
    restored, _ = mgr.restore({"w": torch.zeros((2, 2), dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], torch.ones((2, 2), dtype=torch.bfloat16))
    restored, _ = mgr.restore({"w": np.zeros((2, 2), np.float64)})
    assert restored["w"].dtype == np.float64


def test_restore_keeps_the_like_trees_key_order(tmp_path):
    """A restored dict iterates in its ``like``'s key order (the order a
    fresh train state was built in), not the sorted order the leaves are
    stored in: the optimizer sums its global norm over the leaves in dict
    order, and a resumed run must round it as the uninterrupted one did."""
    like = {"embed": torch.zeros(2), "blocks": {"wq": torch.zeros(3), "attn_norm": torch.zeros(1)},
            "final_norm": torch.zeros(1)}
    tree = {k: (v + 1 if torch.is_tensor(v) else {kk: vv + 2 for kk, vv in v.items()})
            for k, v in like.items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    restored, _ = mgr.restore(like)
    assert list(restored) == ["embed", "blocks", "final_norm"]
    assert list(restored["blocks"]) == ["wq", "attn_norm"]
    assert all(torch.equal(a, b) for a, b in zip(
        [restored["embed"], *restored["blocks"].values(), restored["final_norm"]],
        [tree["embed"], *tree["blocks"].values(), tree["final_norm"]]))


def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    """bfloat16 tensors (numpy has no such dtype) are written as their
    uint16 bit patterns with "bfloat16" in the manifest and restored bit
    for bit, special values included; float32 leaves keep their format."""
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)).bfloat16()
    w[0, :4] = torch.tensor([float("inf"), -0.0, 1e-40, float("nan")]).bfloat16()
    tree = {"w": w, "b": torch.arange(4, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree)
    leaves = _manifest(tmp_path)["leaves"]
    assert [(e["path"], e["dtype"], e["shape"]) for e in leaves] == [
        ("['b']", "float32", [4]), ("['w']", "bfloat16", [3, 5])]
    restored, _ = mgr.restore({"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                               "b": torch.zeros(4)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(restored["b"], tree["b"])
    items, _ = mgr.restore_items()
    np.testing.assert_array_equal(items["w"], w.view(torch.int16).numpy().view(np.uint16))


def test_bf16_train_state_matches_reference_layout(tmp_path):
    """A bf16 TrainState (a dataclass tree): the port writes the
    reference's manifest for the same state (paths, shapes, dtypes, crc32
    over the same bytes), restores it bitwise, and reads the reference's
    bf16 checkpoint bitwise."""
    from repro.configs.base import get_reduced as ref_get_reduced
    from repro.train.trainer import train_state_init as ref_train_state_init
    from repro_torch.configs import get_reduced
    from repro_torch.convert import train_state

    cfg = get_reduced("qwen3-1.7b")
    rstate = ref_train_state_init(jax.random.PRNGKey(0), ref_get_reduced("qwen3-1.7b"))
    state = train_state(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    assert state.params["embed"].dtype == torch.bfloat16
    CheckpointManager(str(tmp_path / "port")).save(7, state)
    RefCheckpointManager(str(tmp_path / "reference")).save(7, rstate)
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "reference")
    for src in ("port", "reference"):
        restored, _ = CheckpointManager(str(tmp_path / src)).restore(state)
        for (path, got), (_, want) in zip(_flatten_with_paths(restored),
                                          _flatten_with_paths(state), strict=True):
            assert got.dtype == want.dtype, path
            assert torch.equal(got.detach().view(torch.uint8) if got.dtype == torch.bfloat16
                               else got.detach(),
                               want.detach().view(torch.uint8) if want.dtype == torch.bfloat16
                               else want.detach()), path


def test_stale_tmp_dirs_cleaned(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    stale = tmp_path / "step_000000003.tmp-9999"
    stale.mkdir()
    mgr.save(4, _items())
    assert not stale.exists()


def test_solver_state_host_roundtrip_bitwise(tmp_path):
    """A mid-solve state and prep through state_to_host/prep_to_host ->
    CheckpointManager -> restore_items -> state_from_host/prep_from_host
    come back bitwise, and a further chunk from the restored pair is
    bitwise the chunk the original would have run."""
    solver = BatchedGMGSolver(beam_hex(), 1, 1, maxiter=100, device="cpu")
    lam, mu = solver.pack_materials(MATS)
    ones = np.ones(2, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(2))
    state, _ = solver.run_chunk(TRACTIONS, REL_TOL, ones, solver.empty_state(2), prep, 2,
                                do_reset=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {**{f"state/{k}": v for k, v in solver.state_to_host(state).items()},
                 **{f"prep/{k}": v for k, v in solver.prep_to_host(prep).items()}},
             extra={"format": 1})
    items, _ = mgr.restore_items()
    state2 = solver.state_from_host({k[6:]: v for k, v in items.items() if k.startswith("state/")})
    prep2 = solver.prep_from_host({k[5:]: v for k, v in items.items() if k.startswith("prep/")})
    for name, arr in solver.state_to_host(state).items():
        got = getattr(state2, name)
        assert got.numpy().dtype == arr.dtype, name
        np.testing.assert_array_equal(got.numpy(), arr, err_msg=name)
    for name, arr in solver.prep_to_host(prep).items():
        np.testing.assert_array_equal(solver.prep_to_host(prep2)[name], arr, err_msg=name)
    zeros = np.zeros(2, bool)
    nxt, c = solver.run_chunk(TRACTIONS, REL_TOL, zeros, state, prep, 3)
    nxt2, c2 = solver.run_chunk(TRACTIONS, REL_TOL, zeros, state2, prep2, 3)
    assert torch.equal(nxt.x, nxt2.x) and torch.equal(nxt.iters, nxt2.iters)
    assert torch.equal(c, c2)


def test_host_roundtrip_checks_the_batch(tmp_path):
    """place=True refuses arrays that do not share one batch size;
    place=False leaves CPU tensors; a snapshot of another
    discretization raises KeyError."""
    solver = BatchedGMGSolver(beam_hex(), 1, 1, device="cpu")
    state = solver.state_to_host(solver.empty_state(2))
    prep = solver.prep_to_host(solver.empty_prep(2))
    assert solver.state_from_host(state, place=False).x.device.type == "cpu"
    with pytest.raises(ValueError, match="batch size"):
        solver.state_from_host({**state, "nom": np.zeros(3)})
    with pytest.raises(ValueError, match="batch size"):
        solver.prep_from_host({**prep, "lam_w1": prep["lam_w1"][:-1]})
    with pytest.raises(KeyError):
        BatchedGMGSolver(beam_hex(), 2, 1, device="cpu").prep_from_host(prep)
    assert solver.state_dtype("iters") == np.int32 and solver.state_dtype("x") == np.float64


# -- either package reads the other's checkpoints ------------------------------
def _tree(leaf):
    """A flat and a nested dict/list/tuple tree of host arrays (``leaf``
    maps each array to what the writer saves)."""
    flat = {"b": leaf(np.arange(6.0).reshape(2, 3)), "a": leaf(np.array([1, 2], np.int32)),
            "c": leaf(np.array([True, False]))}
    nested = {"z": (leaf(np.ones((2, 2), np.float32)), {"y": leaf(np.arange(3.0))}),
              "a": [leaf(np.asfortranarray(np.arange(6.0).reshape(2, 3))),
                    leaf(np.array([0.5]))]}
    return {"flat": flat, "nested": nested}


def _manifest(path) -> dict:
    with open(path / "step_000000007" / "manifest.json") as f:
        return json.load(f)


def _leaves(tree) -> list:
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


@pytest.mark.parametrize("kind", ["flat", "nested"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages(tmp_path, writer, kind):
    """The same tree saved by both managers gives the same manifest
    (paths, shapes, dtypes, crc32 over the bytes, extra); each package
    restores the other's checkpoint, with and without a ``like`` tree.
    The port saves torch tensors where the reference saves arrays."""
    host = _tree(np.asarray)[kind]
    extra = {"format": 1, "note": kind}
    CheckpointManager(str(tmp_path / "port")).save(
        7, _tree(lambda a: torch.from_numpy(np.ascontiguousarray(a)))[kind], extra=extra)
    RefCheckpointManager(str(tmp_path / "reference")).save(7, host, extra=extra)
    mp, mr = _manifest(tmp_path / "port"), _manifest(tmp_path / "reference")
    assert mp == mr

    src = str(tmp_path / writer)
    reader = RefCheckpointManager if writer == "port" else CheckpointManager
    restored, got_extra = reader(src).restore(host)
    assert got_extra == extra
    for got, want in zip(_leaves(restored), _leaves(host), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    items, _ = reader(src).restore_items()
    assert sorted(items) == sorted(
        e["path"][2:-2] if kind == "flat" else e["path"] for e in mr["leaves"])


# -- the solver's host snapshots against the reference's ---------------------
def _mid_solve(ref: bool, precision: str, iters: int = 2):
    """(solver, state, prep) of a 2-row batch after ``iters`` iterations,
    on the reference or on the port (with the reference's start
    vectors)."""
    if ref:
        solver = RefBatchedGMGSolver(ref_beam_hex(), 1, 1, precision=precision, maxiter=100)
    else:
        solver = ref_start_solver(beam_hex(), 1, 1, precision=resolve_precision(precision),
                                  maxiter=100, device="cpu")
    lam, mu = solver.pack_materials(MATS)
    ones = np.ones(2, bool)
    prep = solver.prepare(lam, mu, ones, solver.empty_prep(2))
    state, _ = solver.run_chunk(TRACTIONS, REL_TOL, ones, solver.empty_state(2), prep, iters,
                                do_reset=True)
    return solver, state, prep


def _rel_err(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_host_snapshots_match_reference(precision):
    """Same names, shapes and dtypes.  In f64 every value is within
    1e-12 of max |.|.  Under mixed the V-cycle runs in f32, whose
    rounding differs between XLA and torch: the f64 fine-level twins
    and the f32 weighted fields and dinv are held to 1e-12, the f32
    Cholesky factor and lambda_max to 1e-5 (tens of f32 ulps), and the
    state's iteration counts and flags exactly."""
    rs, rstate, rprep = _mid_solve(True, precision)
    ps, pstate, pprep = _mid_solve(False, precision)
    for want, got in ((rs.state_to_host(rstate), ps.state_to_host(pstate)),
                      (rs.prep_to_host(rprep), ps.prep_to_host(pprep))):
        assert list(got) == list(want)
        for k in want:
            assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    assert bool(np.asarray(rstate.active).all()), "both rows must be mid-solve"
    if precision == "mixed":
        assert "lam_w_solve" in ps.prep_to_host(pprep)
    exact = ("iters", "active", "stall", "stalled")
    for name, want in rs.state_to_host(rstate).items():
        got = ps.state_to_host(pstate)[name]
        if name in exact:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif precision == "f64":
            assert _rel_err(got, want) <= 1e-12, name
    for name, want in rs.prep_to_host(rprep).items():
        tol = 1e-5 if precision == "mixed" and name.startswith(("chol", "lmax")) else 1e-12
        assert _rel_err(ps.prep_to_host(pprep)[name], want) <= tol, name


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's solver state and prep after 2 iterations, written
    by the reference's manager, read by the port's and placed through
    state_from_host/prep_from_host, run to the end in the port: the
    reference's iteration counts and flags, x within 1e-10 of max |x|."""
    rs, rstate, rprep = _mid_solve(True, "f64")
    RefCheckpointManager(str(tmp_path)).save(
        2, {**{f"state/{k}": v for k, v in rs.state_to_host(rstate).items()},
            **{f"prep/{k}": v for k, v in rs.prep_to_host(rprep).items()}})
    items, _ = CheckpointManager(str(tmp_path)).restore_items()
    port = BatchedGMGSolver(beam_hex(), 1, 1, maxiter=100, device="cpu")
    state = port.state_from_host({k[6:]: v for k, v in items.items() if k.startswith("state/")})
    prep = port.prep_from_host({k[5:]: v for k, v in items.items() if k.startswith("prep/")})
    zeros = np.zeros(2, bool)
    state, _ = port.run_chunk(TRACTIONS, REL_TOL, zeros, state, prep, 100)
    rstate, _ = rs.run_chunk(TRACTIONS, REL_TOL, zeros, rstate, rprep, 100)
    np.testing.assert_array_equal(state.iters.numpy(), np.asarray(rstate.iters))
    np.testing.assert_array_equal(state.active.numpy(), np.asarray(rstate.active))
    assert not bool(state.active.any()) and int(state.iters.min()) > 2
    want = np.asarray(rstate.x)
    np.testing.assert_allclose(state.x.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
