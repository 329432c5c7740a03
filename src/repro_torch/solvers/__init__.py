from repro_torch.solvers.cg import pcg
from repro_torch.solvers.chebyshev import ChebyshevSmoother
from repro_torch.solvers.gmg import GMGPreconditioner, build_hierarchy

__all__ = ["pcg", "ChebyshevSmoother", "GMGPreconditioner", "build_hierarchy"]
