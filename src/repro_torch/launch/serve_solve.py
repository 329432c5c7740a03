"""CLI for the batched elasticity solve service on the card.

Generates the reference's mixed multi-scenario workload (varying
materials, tractions and tolerances, optionally across several
discretizations), drives it through
:class:`repro_torch.serve.elasticity_service.ElasticityService`, and
prints per-request reports, aggregate throughput, the service counters,
the scheduler summary and the latency quantiles.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve_solve \
        --n-requests 16 --max-batch 8 --p 2 --refine 1
    PYTHONPATH=src python -m repro_torch.launch.serve_solve --p 1 2  # mixed keys
    PYTHONPATH=src python -m repro_torch.launch.serve_solve --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve_solve \
        --continuous --chunk-policy adaptive   # cadence-driven chunks
    PYTHONPATH=src python -m repro_torch.launch.serve_solve \
        --material-field lognormal:7   # heterogeneous per-element fields
    PYTHONPATH=src python -m repro_torch.launch.serve_solve --continuous \
        --metrics-out metrics.prom --trace-out trace.json  # observability
    PYTHONPATH=src python -m repro_torch.launch.serve_solve --device cpu \
        --continuous --n-requests 5 --p 1 --refine 0   # plain version, CPU

The service runs on the card (``--device cuda``, the default; without a
card it raises) through the PAop kernel (``--assembly paop_cuda``);
``--device cpu`` runs the plain PyTorch version.

``--material-field {graded,checkerboard,lognormal[:seed]}`` replaces the
attribute-dict materials with per-element ``(lam_e, mu_e)`` fields on
the fine mesh; requests cycle through a vocabulary of 4 fields, so the
continuous engine's digest-keyed prep-row reuse engages.

``--chunk-policy {fixed,adaptive,shard-adaptive}`` selects how the
continuous engine picks each chunk's PCG iteration count; scheduling
never changes numerics, and the run prints the scheduler counters.

``--metrics-out`` dumps the service's metrics registry (Prometheus text,
or a JSON snapshot for ``.json`` paths); ``--trace-out`` attaches a
device-fencing span recorder and writes a Chrome ``trace_event`` file
(open it at https://ui.perfetto.dev); ``--events-out`` writes the same
spans as JSON-lines; ``--report-out`` writes one JSON line per report
(ticket, iterations, convergence, sha256 of the solution).

Not ported yet: ``--checkpoint-dir``, ``--checkpoint-every``,
``--resume``, ``--watchdog-timeout`` and ``--kill-after-steps`` (recovery,
ROADMAP Queue 1 item 7) and ``--devices`` (scenario sharding, item 10).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time

import numpy as np

from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.workload import make_workload as make_scenarios
from repro_torch.obs import SpanRecorder
from repro_torch.serve.elasticity_service import ElasticityService, SolveRequest

__all__ = ["make_workload", "main"]


def make_workload(
    n_requests: int,
    ps: list[int],
    refine: int,
    base_tol: float,
    material_field: str | None = None,
) -> list[SolveRequest]:
    """The reference CLI's deterministic mixed workload as requests:
    request i is scenario i of :func:`repro_torch.launch.workload.
    make_workload` (materials, traction, rel_tol) at ``p = ps[i %
    len(ps)]``."""
    mats, tractions, rel_tol = make_scenarios(n_requests, refine, base_tol, material_field)
    return [
        SolveRequest(
            p=ps[i % len(ps)],
            refine=refine,
            materials=mats[i],
            traction=tuple(float(t) for t in tractions[i]),
            rel_tol=float(rel_tol[i]),
        )
        for i in range(n_requests)
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--p", type=int, nargs="+", default=[2])
    ap.add_argument("--refine", type=int, default=1)
    ap.add_argument("--rel-tol", type=float, default=1e-6)
    ap.add_argument("--assembly", default="paop_cuda", choices=["paop_cuda", "paop"],
                    help="paop_cuda: the PAop kernel (card); paop: its plain "
                         "PyTorch version")
    ap.add_argument("--precision", default="f64", choices=["f64", "f32", "mixed"],
                    help="service-default precision policy (requests may "
                         "still name their own).  Reduced policies fall "
                         "stagnated rows back to f64: the report's prec "
                         "column shows the policy that produced each "
                         "answer, * marks a fallback")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-run the workload to show solver cache hits")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (slot refill + bucketed "
                         "padding) instead of generational")
    ap.add_argument("--chunk-iters", type=int, default=8,
                    help="PCG iterations per continuous chunk (fixed "
                         "policy) / no-history fallback (adaptive)")
    ap.add_argument("--chunk-policy", default="fixed",
                    choices=["fixed", "adaptive", "shard-adaptive"],
                    help="continuous chunk scheduling (never changes numerics)")
    ap.add_argument("--min-chunk", type=int, default=None,
                    help="adaptive policies: chunk length lower clamp")
    ap.add_argument("--max-chunk", type=int, default=None,
                    help="adaptive policies: chunk length upper clamp "
                         "(default 4 * chunk-iters)")
    ap.add_argument("--material-field", default=None,
                    metavar="{graded,checkerboard,lognormal[:seed]}",
                    help="heterogeneous per-element (lam_e, mu_e) fields "
                         "instead of attribute dicts")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the service metrics registry as Prometheus "
                         "text (.prom/.txt) or a JSON snapshot (.json)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request/chunk spans (device-fenced) and "
                         "write a Chrome trace_event file")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="also write the spans as a JSON-lines event log")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write one JSON line per report (ticket, "
                         "iterations, converged, rel_norm, precision, "
                         "sha256 of the solution vector)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spans = SpanRecorder() if (args.trace_out or args.events_out) else None
    service = ElasticityService(
        max_batch=args.max_batch, assembly=args.assembly,
        precision=args.precision, chunk_iters=args.chunk_iters,
        chunk_policy=args.chunk_policy, min_chunk=args.min_chunk,
        max_chunk=args.max_chunk, spans=spans, device=device,
    )
    all_reports = []
    for round_i in range(args.repeat):
        reqs = make_workload(
            args.n_requests, args.p, args.refine, args.rel_tol,
            material_field=args.material_field,
        )
        if args.report_out:
            reqs = [dataclasses.replace(r, keep_solution=True) for r in reqs]
        synchronize(device)
        t0 = time.perf_counter()
        if args.continuous:
            for r in reqs:
                service.submit(r)
            service.run_until_idle()
            reports = service.drain()
        else:
            reports = service.solve(reqs)
        synchronize(device)
        dt = time.perf_counter() - t0
        all_reports.extend(reports)
        # Throughput counts REAL requests only (padding rows excluded).
        print(
            f"-- round {round_i}: {len(reports)} scenarios in {dt:.2f}s "
            f"({len(reports) / dt:.2f} scenarios/s) on {device}"
        )
        print(
            f"{'i':>3} {'key':16s} {'prec':>7} {'ndof':>7} {'iters':>5} "
            f"{'conv':>5} {'rel_norm':>9} {'hit':>4} {'rows':>7} "
            f"{'setup(s)':>8} {'solve(s)':>8}"
        )
        for i, rep in enumerate(reports):
            p, refine, shape = rep.key[:3]
            short_key = f"p{p}/r{refine}/{'x'.join(map(str, shape))}"
            rows = f"{rep.batch_size}/{rep.padded_rows}"
            prec = rep.precision + ("*" if rep.fallback else "")
            print(
                f"{i:>3} {short_key:16s} {prec:>7} {rep.ndof:>7} "
                f"{rep.iterations:>5} {str(rep.converged):>5} "
                f"{rep.final_rel_norm:>9.2e} {str(rep.cache_hit):>4} "
                f"{rows:>7} {rep.t_setup:>8.3f} {rep.t_solve:>8.3f}"
            )
    print(f"service stats: {service.stats}")
    if args.report_out:
        with open(args.report_out, "w") as f:
            for rep in all_reports:
                x_hash = (
                    None
                    if rep.x is None
                    else hashlib.sha256(np.ascontiguousarray(rep.x).tobytes()).hexdigest()
                )
                f.write(json.dumps({
                    "ticket": rep.ticket,
                    "iterations": int(rep.iterations),
                    "converged": bool(rep.converged),
                    "final_rel_norm": float(rep.final_rel_norm),
                    "precision": rep.precision,
                    "fallback": bool(rep.fallback),
                    "born_converged": bool(rep.born_converged),
                    "x_sha256": x_hash,
                }) + "\n")
        print(f"reports -> {args.report_out}")
    if args.continuous:
        s = service.trace.summary()
        print(
            f"scheduler[{service.chunk_policy.name}]: "
            f"chunks={s['chunks']} mean_chunk={s['mean_chunk']:.2f} "
            f"wasted_iters={s['wasted_iters']} refills={s['refills']}"
        )
    lat = service.latency_summary()
    if lat:
        print(
            f"latency: p50={lat['p50']:.3f}s p90={lat['p90']:.3f}s "
            f"p99={lat['p99']:.3f}s mean={lat['mean']:.3f}s "
            f"(n={int(lat['count'])})"
        )
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            if args.metrics_out.endswith(".json"):
                f.write(service.registry.to_json(indent=2))
            else:
                f.write(service.registry.to_prometheus_text())
        print(f"metrics -> {args.metrics_out}")
    if spans is not None:
        if args.trace_out:
            spans.to_chrome_trace(args.trace_out)
            print(
                f"trace -> {args.trace_out} "
                f"({spans.count()} spans; open at https://ui.perfetto.dev)"
            )
        if args.events_out:
            spans.to_jsonl(args.events_out)
            print(f"events -> {args.events_out}")


if __name__ == "__main__":
    main()
