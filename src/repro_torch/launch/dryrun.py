"""The dry-run CLI on meta-device meshes (the reference's
``repro.launch.dryrun``).

For every (architecture x input-shape) cell this builds the cell on the
production mesh -- 16 x 16 single-pod and 2 x 16 x 16 multi-pod, every
device the meta device (``launch/mesh.py::make_production_mesh``) -- and
runs it once on shape-only stand-ins: a trace, with nothing allocated and
nothing compiled.  One JSON per cell under ``--out`` records:

* ``t_build_s``, ``t_trace_s``;
* ``cost``: the loop-aware counts of :mod:`repro_torch.launch.jaxpr_cost`,
  global and per device (the global count over the mesh size);
* ``collectives``: the collectives' own tally
  (:func:`repro_torch.distributed.collectives.tally`), per device;
* ``model_flops``: :func:`repro_torch.launch.roofline.model_flops_estimate`;
* ``memory``: ``argument_bytes`` (exact: the fullest device's blocks),
  ``output_bytes`` and ``alias_bytes`` (outputs that are arguments updated
  in place) likewise, ``temp_bytes`` (an estimate: the peak of the storage
  the trace made and kept alive, its outputs included, over the mesh size)
  and ``peak_bytes_per_device`` = argument + temp bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells qwen3_17b:train_4k --mesh single

The trace is one Python program a mesh device (the port is single
controller), so its host time grows with the device count: the whole grid
on both meshes is hours of host time.  A cell that fails is recorded with
its traceback, and the CLI exits nonzero at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

__all__ = ["run_cell", "trace_cell", "main"]


def _by_device(tree, mesh):
    """(device index, tensor) for every tensor of ``tree``: a ``Sharded``
    leaf's block k on device k, a sequence of one tensor a mesh device by
    position, any other tensor on the first device."""
    import torch

    from repro_torch.distributed.sharding import Sharded

    if isinstance(tree, Sharded):
        yield from enumerate(tree.blocks)
    elif isinstance(tree, torch.Tensor):
        yield 0, tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _by_device(v, mesh)
    elif isinstance(tree, (list, tuple)):
        if len(tree) == mesh.size and all(isinstance(t, torch.Tensor) for t in tree):
            yield from enumerate(tree)
        else:
            for v in tree:
                yield from _by_device(v, mesh)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from _by_device(getattr(tree, f), mesh)


def _fullest(tree, mesh, storages: set[int] | None = None) -> int:
    """The most bytes of ``tree``'s tensors on one mesh device (only those
    whose storage is in ``storages``, when given)."""
    per = [0] * mesh.size
    for k, t in _by_device(tree, mesh):
        if storages is None or t.untyped_storage()._cdata in storages:
            per[k] += t.numel() * t.element_size()
    return max(per)


def trace_cell(cell) -> dict:
    """Run ``cell`` once under the cost model and the collectives' tally;
    returns the record's ``t_trace_s``, ``cost``, ``collectives`` and
    ``memory``."""
    from repro_torch.distributed.collectives import tally
    from repro_torch.launch.jaxpr_cost import CostMode

    mesh = cell.mesh
    n = mesh.size
    args_keys = {t.untyped_storage()._cdata for _, t in _by_device(cell.args, mesh)}
    t0 = time.perf_counter()
    mode = CostMode()
    mode.ignore_storage_of([t for _, t in _by_device(cell.args, mesh)])
    with mode, mode.saved_tensors(), tally() as t:
        out = cell.run()
    t_trace = time.perf_counter() - t0
    jc = mode.cost
    arg_b = _fullest(cell.args, mesh)
    temp = mode.peak_bytes / n
    return {
        "t_trace_s": round(t_trace, 3),
        "cost": {
            "flops_global": jc.flops,
            "bytes_global": jc.bytes,
            "dot_flops_global": jc.dot_flops,
            "gather_scatter_bytes_global": jc.gather_scatter_bytes,
            "flops_per_dev": jc.flops / n,
            "bytes_per_dev": jc.bytes / n,
            "has_dynamic_loop": jc.has_dynamic_loop,
        },
        "collectives": t.per_device(n),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": _fullest(out, mesh),
            "alias_bytes": _fullest(out, mesh, args_keys),
            "temp_bytes": int(temp),
            "temp_bytes_is": "estimate: peak of the storage the trace made and kept alive "
                             "(outputs included), over the mesh size",
            "peak_bytes_per_device": int(arg_b + temp),
        },
    }


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str, assembly: str = "paop",
             force: bool = False, *, mesh=None, cfg=None, shape_cfg=None) -> dict:
    """Build and trace one cell on the ``mesh_kind`` production mesh
    (``"single"`` or ``"multi"``; or on ``mesh``, tagged ``mesh_kind``) and
    write its record to ``out_dir``; an ``ok`` record already there is
    returned unless ``force``.  ``cfg`` / ``shape_cfg`` replace the named
    configuration and shape (``build_cell``'s)."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import model_flops_estimate

    tag = f"{arch}__{shape.replace(':', '_')}__{mesh_kind}"
    path = os.path.join(out_dir, f"{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            prev = json.load(f)
        if prev.get("status") == "ok":  # failed cells re-run after fixes
            return prev

    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind, "chips": int(mesh.size),
                 "mesh_shape": mesh.shape, "status": "error"}
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape, mesh, assembly=assembly, cfg=cfg, shape=shape_cfg)
        rec["meta"] = cell.meta
        rec["t_build_s"] = round(time.perf_counter() - t0, 3)
        rec.update(trace_cell(cell))
        if arch == "elasticity":
            rec["dtype"] = "float32"
            rec["model_flops"] = model_flops_estimate("elasticity", shape, cell.meta)
        else:
            from repro_torch.configs.base import SHAPES, get_config

            arch_cfg = cfg or get_config(arch)
            rec["dtype"] = arch_cfg.dtype
            rec["model_flops"] = model_flops_estimate(arch_cfg, shape_cfg or SHAPES[shape])
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["t_total_s"] = round(time.perf_counter() - t0, 3)

    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="all", help="'all' or comma list of arch:shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/torch_dryrun")
    ap.add_argument("--assembly", default="paop",
                    help="elasticity assembly level for FEM cells (paop_cuda: the kernel)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    from repro_torch.launch.cells import cell_ids

    if args.cells == "all":
        cells = cell_ids()
    else:
        cells = [tuple(c.split(":", 1)) for c in args.cells.split(",")]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, args.out, assembly=args.assembly, force=args.force)
            ok = rec["status"] == "ok"
            if not ok:
                failures.append((arch, shape, mk, rec.get("error")))
            mem = rec.get("memory", {}).get("peak_bytes_per_device", 0) / 2**30
            print(
                f"[{'ok' if ok else 'FAIL':4s}] {arch:18s} {shape:14s} {mk:6s} "
                f"build={rec.get('t_build_s', 0):7.1f}s "
                f"trace={rec.get('t_trace_s', 0):7.1f}s "
                f"peak/dev={mem:6.2f} GiB"
                + ("" if ok else f"  {rec.get('error')}"),
                flush=True,
            )
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
