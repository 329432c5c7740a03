"""The port's observability modules (``repro_torch.obs``) against the
reference's (``repro.obs``): the same operations give the same snapshots,
exports, quantiles, span events and schema errors."""

from __future__ import annotations

import copy
import json
import pathlib

import numpy as np
import pytest

from repro.obs import metrics as ref_metrics
from repro.obs import schema as ref_schema
from repro.obs import spans as ref_spans
from repro_torch.obs import metrics, schema, spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCHEMAS = sorted((ROOT / "benchmarks" / "schemas").glob("*.schema.json"))


def _fixed_clock(t=1700000000.25):
    return lambda: t


def _drive_registry(m, seed: int):
    """One sequence of registry operations (counters, gauges and
    histograms over the service's label vocabulary), from a seed."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry(clock=_fixed_clock())
    for _ in range(40):
        p = int(rng.integers(1, 4))
        labels = {"p": p, "refine": int(rng.integers(0, 2)), "policy": "fixed",
                  "devices": 1, "precision": "f64"}
        reg.counter("service_chunks_total", "Chunks.", **labels).inc()
        reg.counter("service_chunk_iters_dispatched_total", "Iters.", **labels).inc(
            float(rng.integers(1, 9)))
        reg.histogram("request_latency_seconds", "Latency.", **labels).observe(
            float(rng.lognormal(-3.0, 1.5)))
        reg.gauge("inflight_rows", "Rows.", p=p).set(float(rng.integers(0, 8)))
    reg.histogram("custom_edges", "Edges.", edges=(0.5, 1.0, 2.0), kind="x").observe(0.75)
    reg.gauge("inflight_rows", "Rows.", p=1).dec(2.0)
    return reg


@pytest.fixture(scope="module")
def registries():
    return {name: [_drive_registry(m, s) for s in (0, 1)]
            for name, m in (("port", metrics), ("ref", ref_metrics))}


def test_snapshot_and_exports_match_reference(registries):
    port, ref = registries["port"][0], registries["ref"][0]
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()["schema"] == ref_metrics.SNAPSHOT_SCHEMA
    assert port.to_prometheus_text() == ref.to_prometheus_text()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    assert port.names() == ref.names()
    for name in ("service_chunks_total", "service_chunk_iters_dispatched_total",
                 "inflight_rows"):
        assert port.total(name) == ref.total(name)
    back = metrics.MetricsRegistry.from_snapshot(ref.snapshot(), clock=_fixed_clock())
    assert back.to_prometheus_text() == ref.to_prometheus_text()


def test_merge_and_diff_snapshots_match_reference(registries):
    pa, pb = (r.snapshot() for r in registries["port"])
    ra, rb = (r.snapshot() for r in registries["ref"])
    assert metrics.merge_snapshots(pa, pb) == ref_metrics.merge_snapshots(ra, rb)
    merged = metrics.merge_snapshots(pa, pb)
    assert metrics.diff_snapshots(merged, pa) == ref_metrics.diff_snapshots(
        ref_metrics.merge_snapshots(ra, rb), ra)
    with pytest.raises(ValueError) as got:
        metrics.diff_snapshots(pa, merged)
    with pytest.raises(ValueError) as want:
        ref_metrics.diff_snapshots(ra, ref_metrics.merge_snapshots(ra, rb))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_quantiles_match_reference(registries, q):
    port = registries["port"][0].merged_histogram("request_latency_seconds")
    ref = registries["ref"][0].merged_histogram("request_latency_seconds")
    assert port.quantile(q) == ref.quantile(q)
    assert port.count == ref.count and port.sum == ref.sum


def test_metric_errors_match_reference():
    for bad in (lambda m: m.Histogram(()), lambda m: m.Histogram((1.0, 1.0)),
                lambda m: m.MetricsRegistry().counter("c").inc(-1),
                lambda m: m.Histogram((1.0,)).quantile(1.5)):
        with pytest.raises(ValueError) as got:
            bad(metrics)
        with pytest.raises(ValueError) as want:
            bad(ref_metrics)
        assert str(got.value) == str(want.value)
    assert metrics.default_latency_edges() == ref_metrics.default_latency_edges()


def _drive_spans(s):
    """Spans from an injected clock that ticks 0.125 s a call."""
    t = [10.0]

    def clock():
        t[0] += 0.125
        return t[0]

    rec = s.SpanRecorder(clock=clock, fence=False)
    rec.thread_name(0, "engine")
    rec.thread_name(3, "p=2 slot 1")
    sid = rec.begin("step", cat="engine", tid=0, step=1)
    rec.emit("queue_wait", cat="request", tid=3, start=10.0, end=10.5, ticket=7)
    rec.emit("chunk_device", cat="chunk", tid=1, start=10.5, end=11.25, chunk=8,
             bucket=4, live=3)
    rec.end(sid, completed=2)
    open_sid = rec.begin("solve", cat="request", tid=3)
    return rec, open_sid


def _span_tuple(s):
    return (s.name, s.cat, s.tid, s.start, s.end, s.args)


def test_span_events_and_exports_match_reference(tmp_path):
    port, port_open = _drive_spans(spans)
    ref, ref_open = _drive_spans(ref_spans)
    assert port_open == ref_open
    assert port.open_count == ref.open_count == 1
    assert [_span_tuple(s) for s in port.spans] == [_span_tuple(s) for s in ref.spans]
    assert port.to_events() == ref.to_events()
    assert port.count() == ref.count() and port.count("step") == ref.count("step") == 1
    for rec, tag in ((port, "port"), (ref, "ref")):
        rec.to_chrome_trace(str(tmp_path / f"{tag}.json"))
        rec.to_jsonl(str(tmp_path / f"{tag}.jsonl"))
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"port.{ext}").read_text() == (tmp_path / f"ref.{ext}").read_text()
    doc = json.loads((tmp_path / "port.json").read_text())
    assert doc["otherData"]["schema"] == ref_spans.EVENTS_SCHEMA
    with pytest.raises(RuntimeError) as got:
        port.clear()
    with pytest.raises(RuntimeError) as want:
        ref.clear()
    assert str(got.value) == str(want.value)


def _mutated(doc: dict) -> dict:
    """The operator-sweep artifact with a wrong type, a missing required
    key, a bad enum value and a negative rate."""
    bad = copy.deepcopy(doc)
    bad["rows"][0]["dofs_per_s"] = -1.0
    bad["rows"][1]["p"] = "four"
    del bad["rows"][2]["dtype"]
    bad["schema"] = "not-a-schema"
    bad.pop("host", None)
    return bad


@pytest.mark.parametrize("mutate", [False, True], ids=["artifact", "mutated"])
@pytest.mark.parametrize("schema_path", SCHEMAS, ids=lambda p: p.name)
def test_schema_validator_matches_reference(schema_path, mutate):
    sch = json.loads(schema_path.read_text())
    doc = json.loads((ROOT / "BENCH_operator_sweep.json").read_text())
    if mutate:
        doc = _mutated(doc)
    errors = schema.validation_errors(doc, sch)
    assert errors == ref_schema.validation_errors(doc, sch)
    if errors:
        with pytest.raises(schema.SchemaError) as got:
            schema.validate_json(doc, sch)
        with pytest.raises(ref_schema.SchemaError) as want:
            ref_schema.validate_json(doc, sch)
        assert str(got.value) == str(want.value)
        assert isinstance(got.value, ValueError)
    if mutate:
        assert errors
