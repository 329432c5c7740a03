"""Serving on the port: the batched elasticity solve service and LM
serving (batched prefill + decode)."""

from repro_torch.serve.chunk_policy import (  # noqa: F401
    AdaptiveChunkPolicy,
    ChunkObservation,
    ChunkPolicy,
    FixedChunkPolicy,
    SchedulerTrace,
    ShardAdaptiveChunkPolicy,
    make_chunk_policy,
    simulate_cadence_trace,
)
from repro_torch.serve.elasticity_service import (  # noqa: F401
    ElasticityService,
    SolveReport,
    SolveRequest,
)
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: F401
