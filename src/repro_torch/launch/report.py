"""Render the dry-run and roofline tables from the dry-run's records in
``runs/torch_dryrun/*.json`` (the reference's ``repro.launch.report``), on
an H100 SXM (``launch/roofline.py::H100_SXM``; the compute term at the
peak of each cell's dtype).

    PYTHONPATH=src python -m repro_torch.launch.report --dir runs/torch_dryrun

A record that carries a time measured on a card (``measured_s``, with the
card in ``measured_on``, and ``measured_devices``, how many of the cell's
devices that card ran, virtual devices queued on it) gets one more roofline
column: the fraction of the roof that the time reached (``place_measured``
of those devices' FLOPs and bytes; 1.0 = at the bound).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from repro_torch.launch.roofline import (
    H100_SXM,
    RooflineTerms,
    place_measured,
    roofline_from_artifacts,
)

__all__ = ["load_records", "terms_of", "measured_fraction", "render_dryrun", "render_roofline"]


def load_records(d: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def terms_of(rec: dict) -> RooflineTerms:
    c = rec["cost"]
    return roofline_from_artifacts(
        flops_per_dev=c["flops_per_dev"],
        bytes_per_dev=c["bytes_per_dev"],
        chips=rec["chips"],
        model_flops=rec.get("model_flops", 0.0),
        coll=rec["collectives"],
        dtype=getattr(torch, rec.get("dtype", "float32")),
        hw=H100_SXM,
    )


def measured_fraction(rec: dict) -> float | None:
    """The fraction of the roof a measured time reached, or None."""
    if not rec.get("measured_s"):
        return None
    c, n = rec["cost"], rec.get("measured_devices", 1)
    return place_measured(flops_per_apply=n * c["flops_per_dev"],
                          bytes_per_apply=n * c["bytes_per_dev"], t_apply_s=rec["measured_s"],
                          hw=H100_SXM, dtype=getattr(torch, rec.get("dtype", "float32"))).fraction


def render_dryrun(recs: list[dict]) -> str:
    out = [
        "| arch | shape | mesh | status | build s | trace s | "
        "peak GiB/dev | flops/dev | collective GiB/dev (link) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        ok = r.get("status") == "ok"
        mem = r.get("memory", {}).get("peak_bytes_per_device", 0) / 2**30
        coll = r.get("collectives", {}).get("link_bytes", 0) / 2**30
        flops = r.get("cost", {}).get("flops_per_dev", 0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{'ok' if ok else 'FAIL'} | {r.get('t_build_s', '')} | "
            f"{r.get('t_trace_s', '')} | {mem:.2f} | {flops:.3e} | "
            f"{coll:.3f} |"
        )
    return "\n".join(out)


def render_roofline(recs: list[dict], mesh: str = "single") -> str:
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "bound s | MODEL/counted flops | roofline frac | measured s | measured frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        t = terms_of(r)
        frac = measured_fraction(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {t.compute_s:.4e} | "
            f"{t.memory_s:.4e} | {t.collective_s:.4e} | {t.dominant} | "
            f"{t.bound_s:.4e} | {t.useful_flops_ratio:.2f} | "
            f"{t.roofline_fraction:.3f} | "
            f"{'' if frac is None else format(r['measured_s'], '.4e')} | "
            f"{'' if frac is None else format(frac, '.3f')} |"
        )
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/torch_dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    recs = load_records(args.dir)
    n_ok = sum(r.get("status") == "ok" for r in recs)
    print(f"## Dry-run ({n_ok}/{len(recs)} cells ok)\n")
    print(render_dryrun(recs))
    print(f"\n## Roofline ({args.mesh} mesh, {H100_SXM.name} constants)\n")
    print(render_roofline(recs, args.mesh))


if __name__ == "__main__":
    main()
