from repro_torch.solvers.batched import (
    BatchedGMGSolver,
    BpcgState,
    BPCGResult,
    bpcg,
    bpcg_chunk,
    bpcg_init,
    bpcg_result,
    merge_states,
    true_residual_audit,
)
from repro_torch.solvers.cg import pcg
from repro_torch.solvers.chebyshev import ChebyshevSmoother
from repro_torch.solvers.gmg import GMGPreconditioner, build_hierarchy

__all__ = [
    "pcg",
    "ChebyshevSmoother",
    "GMGPreconditioner",
    "build_hierarchy",
    "bpcg",
    "bpcg_init",
    "bpcg_chunk",
    "bpcg_result",
    "true_residual_audit",
    "merge_states",
    "BpcgState",
    "BPCGResult",
    "BatchedGMGSolver",
]
