"""Observability for the port's solve service: metrics, spans, schemas.

* :mod:`repro_torch.obs.metrics` — a typed metrics registry (counters,
  gauges, fixed-bucket histograms with quantile estimation), labeled by
  ``(p, refine, policy, devices)``, with snapshot/merge/diff semantics
  and Prometheus-text + JSON export.  ``ElasticityService.stats`` is a
  read-only view over one of these.
* :mod:`repro_torch.obs.spans` — per-request lifecycle spans and
  per-chunk device-fenced timing, exportable as a JSON-lines event log
  and a Chrome ``trace_event`` file viewable in Perfetto.
* :mod:`repro_torch.obs.schema` — a dependency-free JSON-schema
  validator for the ``BENCH_*.json`` artifact schemas checked into
  ``benchmarks/schemas/``.
* :mod:`repro_torch.obs.throughput` — device-fenced operator-apply
  throughput (DoF/s) for every assembly level, each row placed on the
  card's roofline (:mod:`repro_torch.launch.roofline`).
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_edges,
    merge_snapshots,
    diff_snapshots,
)
from repro_torch.obs.spans import Span, SpanRecorder
from repro_torch.obs.schema import SchemaError, validate_json
from repro_torch.obs.throughput import (
    model_flops_per_elem,
    operator_throughput,
    streaming_bytes_per_elem,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_latency_edges",
    "merge_snapshots",
    "diff_snapshots",
    "Span",
    "SpanRecorder",
    "SchemaError",
    "validate_json",
    "model_flops_per_elem",
    "operator_throughput",
    "streaming_bytes_per_elem",
]
