"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints, in order:

* **cheap on the hot path** — a counter increment is a float add on a
  cached cell object; no locks, no string formatting, no allocation
  after the first touch of a ``(name, labels)`` cell;
* **deterministic and testable** — the registry takes an injectable
  clock (only used to stamp exports), histograms have *fixed* bucket
  edges declared at creation, and every aggregate is derivable from a
  plain-data :meth:`MetricsRegistry.snapshot`;
* **windowable** — :func:`diff_snapshots` subtracts an earlier snapshot
  (counters and histogram buckets are monotone), which is how a
  benchmark reports "this workload's" latency distribution from a
  long-lived registry, and :func:`merge_snapshots` adds snapshots from
  independent registries (e.g. per-process shards);
* **exportable** — :meth:`to_prometheus_text` emits the Prometheus text
  exposition format; :meth:`to_json` a schema-versioned JSON document.

Labels are free-form ``str -> str`` pairs; the serving stack uses the
``(p, refine, policy, devices)`` vocabulary throughout.  Snapshot and
export formats (``SNAPSHOT_SCHEMA``) are those of the reference
package's registry, so snapshots of the two compare equal.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import time
from typing import Iterable, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_latency_edges",
    "merge_snapshots",
    "diff_snapshots",
]

SNAPSHOT_SCHEMA = "repro.obs.metrics/v1"

Labels = tuple[tuple[str, str], ...]


def _label_key(labels: Mapping[str, object]) -> Labels:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def default_latency_edges() -> tuple[float, ...]:
    """Log-spaced latency bucket upper bounds (seconds): 1 ms .. ~100 s,
    8 buckets per decade.  Wide enough for CPU-interpret solves and
    tight enough (~33%/bucket) for meaningful p50/p95 interpolation."""
    edges = []
    e = 1e-3
    while e < 120.0:
        edges.append(round(e, 12))
        e *= 10 ** (1 / 8)
    return tuple(edges)


class Counter:
    """Monotone counter.  ``inc`` rejects negative deltas so diffs of
    snapshots are always well-defined."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class Histogram:
    """Fixed-bucket histogram (Prometheus ``le`` convention: bucket i
    counts observations ``v <= edges[i]``; one implicit +inf bucket).

    Tracks observed min/max next to the buckets so
    :meth:`quantile` can clamp interpolation to the observed range —
    without it, a single sample in a wide bucket would report the
    bucket's midpoint instead of something near the sample."""

    __slots__ = ("edges", "counts", "sum", "count", "vmin", "vmax")
    kind = "histogram"

    def __init__(self, edges: Iterable[float]):
        edges = tuple(float(e) for e in edges)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        for a, b in zip(edges, edges[1:]):
            if not a < b:
                raise ValueError(
                    f"histogram edges must be strictly increasing, got "
                    f"{a} before {b}"
                )
        if not all(math.isfinite(e) for e in edges):
            raise ValueError("histogram edges must be finite (+inf is implicit)")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) by linear interpolation
        inside the bucket holding it, clamped to the observed
        [min, max].  NaN on an empty histogram.  This is THE percentile
        implementation for the serving stack — the benchmark and the
        service summary both call it (no more ad-hoc np.percentile on
        raw lists)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.edges[i - 1] if i > 0 else self.vmin
            hi = self.edges[i] if i < len(self.edges) else self.vmax
            lo = max(lo, self.vmin)
            hi = min(hi, self.vmax)
            if cum + c >= rank:
                frac = 0.0 if c == 0 else (rank - cum) / c
                return min(max(lo + frac * (hi - lo), self.vmin), self.vmax)
            cum += c
        return self.vmax

    def quantiles(self, qs: Iterable[float]) -> list[float]:
        return [self.quantile(q) for q in qs]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: kind, help text, shared edges, labeled cells."""

    __slots__ = ("name", "kind", "help", "edges", "cells")

    def __init__(self, name, kind, help="", edges=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.edges = edges
        self.cells: dict[Labels, object] = {}

    def cell(self, labels: Labels):
        c = self.cells.get(labels)
        if c is None:
            c = (
                Histogram(self.edges)
                if self.kind == "histogram"
                else _KINDS[self.kind]()
            )
            self.cells[labels] = c
        return c


_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Get-or-create registry of metric families.

    ``counter(name, **labels)`` / ``gauge`` / ``histogram`` return the
    live cell for that label set — hold on to it on hot paths.
    Re-registering a name with a different kind (or different histogram
    edges) is an error: one name, one meaning.

    ``clock`` stamps exports (``to_json``) — inject a fake for
    deterministic artifacts in tests."""

    def __init__(self, clock=time.time):
        self.clock = clock
        self._families: dict[str, _Family] = {}

    # -- registration --------------------------------------------------------
    def _family(self, name, kind, help, edges=None) -> _Family:
        if not _NAME_OK.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help, edges)
            self._families[name] = fam
            return fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"cannot re-register as {kind}"
            )
        if kind == "histogram" and edges is not None and tuple(
            float(e) for e in edges
        ) != tuple(fam.edges):
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"bucket edges"
            )
        if help and not fam.help:
            fam.help = help
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._family(name, "counter", help).cell(_label_key(labels))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._family(name, "gauge", help).cell(_label_key(labels))

    def histogram(
        self, name: str, help: str = "", *, edges=None, **labels
    ) -> Histogram:
        if edges is None and name not in self._families:
            edges = default_latency_edges()
        fam = self._family(name, "histogram", help, edges)
        return fam.cell(_label_key(labels))

    # -- reads ---------------------------------------------------------------
    def names(self) -> list[str]:
        return sorted(self._families)

    def value(self, name: str, **labels) -> float:
        """One cell's value (counter/gauge).  0.0 for a never-touched
        label set of a registered family; KeyError on an unknown name."""
        fam = self._families[name]
        if fam.kind == "histogram":
            raise TypeError(f"{name!r} is a histogram; use get_histogram")
        c = fam.cells.get(_label_key(labels))
        return 0.0 if c is None else c.value

    def total(self, name: str) -> float:
        """Sum of a counter/gauge family across every label set (0.0
        for an unknown name — callers aggregate optimistically)."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        if fam.kind == "histogram":
            raise TypeError(f"{name!r} is a histogram; use get_histogram")
        return sum(c.value for c in fam.cells.values())

    def get_histogram(self, name: str, **labels) -> Histogram | None:
        fam = self._families.get(name)
        if fam is None:
            return None
        if fam.kind != "histogram":
            raise TypeError(f"{name!r} is a {fam.kind}, not a histogram")
        return fam.cells.get(_label_key(labels))

    def merged_histogram(self, name: str) -> Histogram | None:
        """All of a histogram family's cells merged into one (same
        edges), e.g. latency across every (p, refine) label set."""
        fam = self._families.get(name)
        if fam is None or not fam.cells:
            return None
        if fam.kind != "histogram":
            raise TypeError(f"{name!r} is a {fam.kind}, not a histogram")
        out = Histogram(fam.edges)
        for h in fam.cells.values():
            out.counts = [a + b for a, b in zip(out.counts, h.counts)]
            out.sum += h.sum
            out.count += h.count
            out.vmin = min(out.vmin, h.vmin)
            out.vmax = max(out.vmax, h.vmax)
        return out

    # -- snapshot / merge / diff ---------------------------------------------
    def snapshot(self) -> dict:
        """Plain-data copy of every family and cell (JSON-able).  The
        canonical interchange form: ``merge_snapshots`` /
        ``diff_snapshots`` operate on these, and
        :meth:`from_snapshot` restores a live registry."""
        fams = {}
        for name in sorted(self._families):
            fam = self._families[name]
            cells = []
            for labels in sorted(fam.cells):
                c = fam.cells[labels]
                entry: dict = {"labels": dict(labels)}
                if fam.kind == "histogram":
                    entry.update(
                        counts=list(c.counts),
                        sum=c.sum,
                        count=c.count,
                        min=None if c.count == 0 else c.vmin,
                        max=None if c.count == 0 else c.vmax,
                    )
                else:
                    entry["value"] = c.value
                cells.append(entry)
            fams[name] = {"kind": fam.kind, "help": fam.help, "cells": cells}
            if fam.kind == "histogram":
                fams[name]["edges"] = list(fam.edges)
        return {"schema": SNAPSHOT_SCHEMA, "families": fams}

    @classmethod
    def from_snapshot(cls, snap: dict, clock=time.time) -> "MetricsRegistry":
        """Inverse of :meth:`snapshot` (exact round-trip)."""
        if snap.get("schema") != SNAPSHOT_SCHEMA:
            raise ValueError(
                f"unknown metrics snapshot schema {snap.get('schema')!r}"
            )
        reg = cls(clock=clock)
        for name, fam in snap["families"].items():
            f = reg._family(name, fam["kind"], fam.get("help", ""),
                            fam.get("edges"))
            for cell in fam["cells"]:
                labels = _label_key(cell["labels"])
                c = f.cell(labels)
                if fam["kind"] == "histogram":
                    c.counts = list(cell["counts"])
                    c.sum = float(cell["sum"])
                    c.count = int(cell["count"])
                    c.vmin = math.inf if cell["min"] is None else cell["min"]
                    c.vmax = -math.inf if cell["max"] is None else cell["max"]
                else:
                    c.value = float(cell["value"])
        return reg

    # -- exports -------------------------------------------------------------
    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (counters get the ``_total``
        name as-is — the serving metrics already carry the suffix)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels in sorted(fam.cells):
                c = fam.cells[labels]
                if fam.kind == "histogram":
                    cum = 0
                    for e, n in zip(fam.edges, c.counts):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_prom_labels(labels, le=_prom_float(e))} {cum}"
                        )
                    lines.append(
                        f'{name}_bucket{_prom_labels(labels, le="+Inf")} '
                        f"{c.count}"
                    )
                    lines.append(
                        f"{name}_sum{_prom_labels(labels)} {_prom_float(c.sum)}"
                    )
                    lines.append(
                        f"{name}_count{_prom_labels(labels)} {c.count}"
                    )
                else:
                    lines.append(
                        f"{name}{_prom_labels(labels)} {_prom_float(c.value)}"
                    )
        return "\n".join(lines) + "\n"

    def to_json(self, indent: int | None = None) -> str:
        doc = self.snapshot()
        doc["generated_unix"] = float(self.clock())
        return json.dumps(doc, indent=indent, sort_keys=True)


def _prom_float(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _prom_labels(labels: Labels, **extra) -> str:
    items = list(labels) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            k, str(v).replace("\\", "\\\\").replace('"', '\\"')
        )
        for k, v in items
    )
    return "{" + body + "}"


# -- snapshot algebra --------------------------------------------------------
def _check_schema(snap: dict) -> dict:
    if snap.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"unknown metrics snapshot schema {snap.get('schema')!r}"
        )
    return snap["families"]


def _cells_by_labels(fam: dict) -> dict:
    return {_label_key(c["labels"]): c for c in fam["cells"]}


def _combine(a: dict, b: dict, counter_op, hist_op, gauge_pick) -> dict:
    """Shared walk for merge/diff: families by name, cells by labels."""
    fa, fb = _check_schema(a), _check_schema(b)
    out_fams: dict = {}
    for name in sorted(set(fa) | set(fb)):
        pa, pb = fa.get(name), fb.get(name)
        proto = pa or pb
        if pa and pb:
            if pa["kind"] != pb["kind"]:
                raise ValueError(
                    f"metric {name!r}: kind mismatch "
                    f"({pa['kind']} vs {pb['kind']})"
                )
            if pa["kind"] == "histogram" and pa["edges"] != pb["edges"]:
                raise ValueError(f"histogram {name!r}: edge mismatch")
        ca = _cells_by_labels(pa) if pa else {}
        cb = _cells_by_labels(pb) if pb else {}
        cells = []
        for labels in sorted(set(ca) | set(cb)):
            xa, xb = ca.get(labels), cb.get(labels)
            if proto["kind"] == "histogram":
                cells.append(hist_op(labels, xa, xb, len(proto["edges"])))
            elif proto["kind"] == "counter":
                va = xa["value"] if xa else 0.0
                vb = xb["value"] if xb else 0.0
                cells.append(
                    {"labels": dict(labels), "value": counter_op(va, vb)}
                )
            else:
                cells.append(
                    {"labels": dict(labels), "value": gauge_pick(xa, xb)}
                )
        out_fams[name] = {
            "kind": proto["kind"],
            "help": proto.get("help", ""),
            "cells": cells,
        }
        if proto["kind"] == "histogram":
            out_fams[name]["edges"] = list(proto["edges"])
    return {"schema": SNAPSHOT_SCHEMA, "families": out_fams}


def _zero_hist_cell(labels: Labels, nedges: int) -> dict:
    return {
        "labels": dict(labels),
        "counts": [0] * (nedges + 1),
        "sum": 0.0,
        "count": 0,
        "min": None,
        "max": None,
    }


def merge_snapshots(a: dict, b: dict) -> dict:
    """Element-wise sum of two snapshots (counters and histogram buckets
    add; gauges take ``b``'s value when both have the cell).  Use to
    aggregate registries from independent shards/processes."""

    def hist(labels, xa, xb, nedges):
        xa = xa or _zero_hist_cell(labels, nedges)
        xb = xb or _zero_hist_cell(labels, nedges)
        mins = [m for m in (xa["min"], xb["min"]) if m is not None]
        maxs = [m for m in (xa["max"], xb["max"]) if m is not None]
        return {
            "labels": dict(labels),
            "counts": [p + q for p, q in zip(xa["counts"], xb["counts"])],
            "sum": xa["sum"] + xb["sum"],
            "count": xa["count"] + xb["count"],
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
        }

    return _combine(
        a,
        b,
        counter_op=lambda va, vb: va + vb,
        hist_op=hist,
        gauge_pick=lambda xa, xb: (xb or xa)["value"],
    )


def diff_snapshots(new: dict, old: dict) -> dict:
    """``new - old``: the window between two snapshots of the SAME
    registry.  Counters and histogram buckets subtract (negative
    results raise — counters are monotone, so going backwards means the
    snapshots are from different registries); gauges take ``new``."""

    def counter(vn, vo):
        d = vn - vo
        if d < -1e-9:
            raise ValueError(
                "diff_snapshots: counter went backwards (snapshots are "
                "not from the same registry?)"
            )
        return max(d, 0.0)

    def hist(labels, xn, xo, nedges):
        xn = xn or _zero_hist_cell(labels, nedges)
        xo = xo or _zero_hist_cell(labels, nedges)
        counts = [p - q for p, q in zip(xn["counts"], xo["counts"])]
        if any(c < 0 for c in counts):
            raise ValueError(
                "diff_snapshots: histogram bucket went backwards"
            )
        # Window min/max are unknowable from cumulative data; the new
        # snapshot's observed range is the tightest safe bound.
        return {
            "labels": dict(labels),
            "counts": counts,
            "sum": xn["sum"] - xo["sum"],
            "count": xn["count"] - xo["count"],
            "min": xn["min"],
            "max": xn["max"],
        }

    return _combine(
        new,
        old,
        counter_op=counter,
        hist_op=hist,
        gauge_pick=lambda xn, xo: (xn or xo)["value"],
    )
