"""End-to-end driver for the paper's benchmark: the two-material
cantilever beam under a constant downward traction, solved by
GMG-preconditioned PCG (paper Sec. 5.1.4), on the card by default.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.solve --p 4 --refine 4
    PYTHONPATH=src python -m repro_torch.launch.solve --p 4 --refine 4 --assembly pa_baseline

``--assembly`` takes every level of the paper's ablation
(:data:`~repro_torch.core.operators.ASSEMBLY_LEVELS`, default ``paop_cuda``);
the report line names it.

Reports the paper's phase breakdown: Prec. (preconditioner setup),
Form-LS (RHS + constraint elimination), Solve (outer PCG), Total, and the
iteration count.  Phases are timed on the host clock between
``torch.cuda.synchronize()`` fences, and are marked as
``torch.profiler.record_function`` ranges (``solve_beam.precond``,
``solve_beam.form``, ``solve_beam.pcg``), which cost next to nothing
without a profiler.  ``--profile`` solves a second time under ``torch.profiler``
and prints, per phase and per kernel, host and device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Sequence

import torch
from torch.profiler import record_function

from repro_torch.core.geometry import MATERIALS_BEAM
from repro_torch.core.operators import ASSEMBLY_LEVELS, ElasticityOperator
from repro_torch.core.precision import resolve_precision
from repro_torch.device import resolve_device, synchronize
from repro_torch.fem.bc import eliminate_rhs
from repro_torch.fem.mesh import beam_hex
from repro_torch.profiling import print_profile
from repro_torch.solvers.cg import pcg
from repro_torch.solvers.gmg import build_hierarchy

TRACTION = (0.0, 0.0, -1e-2)


@dataclasses.dataclass
class SolveReport:
    p: int
    assembly: str
    ndof: int
    nelem: int
    iterations: int
    t_precond: float
    t_form_ls: float
    t_solve: float
    t_total: float
    final_rel_norm: float
    converged: bool
    precision: str = "f64"
    device: str = "cuda"
    x: Any = None


def solve_beam(
    p: int,
    n_h_refine: int = 1,
    assembly: str = "paop_cuda",
    coarse_mesh=None,
    rel_tol: float = 1e-6,
    maxiter: int = 5000,
    coarse_method: str = "cholesky",
    dtype: torch.dtype | None = None,
    precision: str | None = None,
    keep_solution: bool = False,
    materials=None,
    traction=TRACTION,
    device=None,
    start_vectors: Sequence[torch.Tensor] | None = None,
    seed: int = 1234,
) -> SolveReport:
    """Solve the beam benchmark once.  ``precision`` names a
    :class:`~repro_torch.core.precision.PrecisionPolicy`: the GMG
    hierarchy is built at the policy's ``precond_dtype`` while the outer
    PCG runs at ``solve_dtype``, with casts only at the preconditioner
    boundary; over a bfloat16 V-cycle it is flexible PCG
    (:func:`~repro_torch.solvers.cg.pcg`).  ``start_vectors`` are the power iterations' start vectors
    (see :func:`~repro_torch.solvers.gmg.build_hierarchy`)."""
    device = resolve_device(device)
    # The f32 tiers must not drop to TF32 in the transfer einsums.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    policy = resolve_precision(precision, dtype)
    coarse_mesh = coarse_mesh if coarse_mesh is not None else beam_hex()
    materials = materials if materials is not None else MATERIALS_BEAM
    synchronize(device)
    t0 = time.perf_counter()

    # --- preconditioner setup (GMG hierarchy, smoothers, coarse factor)
    with record_function("solve_beam.precond"):
        gmg = build_hierarchy(
            coarse_mesh,
            n_h_refine,
            p,
            assembly=assembly,
            materials=materials,
            dtype=policy.precond_dtype,
            device=device,
            coarse_method=coarse_method,
            start_vectors=start_vectors,
            seed=seed,
        )
        fine = gmg.fine
        sdt = policy.solve_dtype
        if sdt != policy.precond_dtype:
            # Split-precision fine level: the outer Krylov streams its own
            # solve-dtype operator; the V-cycle is entered/left via casts.
            solve_op = ElasticityOperator(
                fine.space,
                assembly=assembly,
                materials=materials,
                dtype=sdt,
                device=device,
            )
            A = solve_op.constrained()
            pdt = policy.precond_dtype
            M = lambda r: gmg(r.to(pdt)).to(sdt)  # noqa: E731
            rhs_op, ess_mask = solve_op.apply, solve_op.ess_mask
        else:
            A, M = fine.constrained, gmg
            rhs_op, ess_mask = fine.operator.apply, fine.ess_mask
        synchronize(device)
    t1 = time.perf_counter()

    # --- form linear system: traction RHS + essential elimination
    with record_function("solve_beam.form"):
        b = torch.as_tensor(
            fine.space.traction_rhs("x1", traction), dtype=sdt, device=device
        )
        b = eliminate_rhs(rhs_op, ess_mask, b)
        synchronize(device)
    t2 = time.perf_counter()

    # --- outer PCG with the GMG preconditioner
    with record_function("solve_beam.pcg"):
        res = pcg(A, b, M=M, rel_tol=rel_tol, maxiter=maxiter,
                  flexible=policy.precond_dtype == torch.bfloat16)
        synchronize(device)
    t3 = time.perf_counter()

    return SolveReport(
        p=p,
        assembly=assembly,
        ndof=fine.space.ndof,
        nelem=fine.space.nelem,
        iterations=res.iterations,
        t_precond=t1 - t0,
        t_form_ls=t2 - t1,
        t_solve=t3 - t2,
        t_total=t3 - t0,
        final_rel_norm=res.final_norm / res.initial_norm,
        converged=res.converged,
        precision=policy.name,
        device=str(device),
        x=res.x if keep_solution else None,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--refine", type=int, default=1)
    ap.add_argument("--assembly", default="paop_cuda", choices=ASSEMBLY_LEVELS)
    ap.add_argument("--coarse", default="cholesky", choices=["cholesky", "pcg_jacobi"])
    ap.add_argument("--rel-tol", type=float, default=1e-6)
    ap.add_argument("--precision", default="f64",
                    choices=["f64", "f32", "mixed", "mixed-bf16"],
                    help="precision policy: uniform f64/f32, or mixed / "
                         "mixed-bf16 (f64 outer PCG over an f32 / bfloat16 "
                         "V-cycle; mixed-bf16 factors the coarse level in "
                         "f32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch version)")
    ap.add_argument("--profile", action="store_true",
                    help="solve again under torch.profiler and print host "
                         "and device time per phase and per kernel")
    args = ap.parse_args(argv)

    def run():
        return solve_beam(
            args.p,
            args.refine,
            assembly=args.assembly,
            rel_tol=args.rel_tol,
            coarse_method=args.coarse,
            precision=args.precision,
            device=args.device,
        )

    rep = run()
    print(
        f"p={rep.p} assembly={rep.assembly} precision={rep.precision} "
        f"device={rep.device} ndof={rep.ndof} "
        f"iters={rep.iterations} prec={rep.t_precond:.3f}s "
        f"form={rep.t_form_ls:.3f}s solve={rep.t_solve:.3f}s "
        f"total={rep.t_total:.3f}s rel={rep.final_rel_norm:.2e}"
    )
    if args.profile:
        print_profile(run, prefix="solve_beam.")


if __name__ == "__main__":
    main()
