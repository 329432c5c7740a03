"""Span recording: request lifecycles and device-fenced chunk timing.

A :class:`SpanRecorder` collects closed intervals (``Span``\\ s) from the
serving stack and exports them two ways:

* a **JSON-lines event log** (:meth:`SpanRecorder.to_jsonl`) — one span
  per line, trivially greppable / streamable;
* a **Chrome ``trace_event`` file** (:meth:`SpanRecorder.to_chrome_trace`)
  — open it at https://ui.perfetto.dev to see the engine's timeline:
  one track per in-flight discretization key (prep + chunk spans, the
  chunk split into host ``dispatch`` and device-fenced ``device``
  phases) and one track per batch slot (``queue_wait`` then ``solve``
  per request riding that slot).

The service's span taxonomy is that of the reference package's
``docs/OBSERVABILITY.md``; event and export formats are unchanged.

Device fencing: PyTorch launches on the card asynchronously, so
wall-clock around a ``run_chunk`` call measures *host dispatch*, not
compute.  When a recorder with ``fence`` set is installed the service
fences each chunk with a device synchronize — splitting dispatch from
device compute — WITHOUT fetching the deferred per-row consumed vector
(fencing waits for completion; it does not transfer), so the consumed
fetch still rides the next retire pass.  With no recorder installed
there is no fence and no per-chunk sync at all.

``clock`` is injectable (default ``time.perf_counter``); the injected-
clock tests drive it deterministically and assert the lifecycle
identity *queue_wait + compute + overhead == wall* per ticket exactly.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

__all__ = ["Span", "SpanRecorder"]

EVENTS_SCHEMA = "repro.obs.spans/v1"


@dataclasses.dataclass
class Span:
    """One closed interval.  ``tid`` selects the Chrome-trace track
    (the recorder's ``thread_name`` map names it); ``args`` is plain
    JSON-able metadata."""

    name: str
    cat: str
    tid: int
    start: float
    end: float
    args: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class SpanRecorder:
    """Collects spans; tracks open begin/end pairs so a leak is
    detectable (``open_count`` must be 0 when the engine is idle).

    ``fence=True`` (default) asks the service to device-fence each
    chunk so dispatch and compute separate; ``fence=False`` records
    host-side dispatch times only (no extra synchronization)."""

    def __init__(self, clock=time.perf_counter, fence: bool = True):
        self.clock = clock
        self.fence = fence
        self.spans: list[Span] = []
        self._open: dict[int, Span] = {}
        self._next_id = 0
        self._thread_names: dict[int, str] = {}

    # -- recording -----------------------------------------------------------
    def begin(self, name: str, *, cat: str = "", tid: int = 0, **args) -> int:
        """Open a span now; returns the id to :meth:`end` it with."""
        sid = self._next_id
        self._next_id += 1
        self._open[sid] = Span(
            name=name, cat=cat, tid=tid, start=self.clock(), end=-1.0,
            args=dict(args),
        )
        return sid

    def end(self, sid: int, **args) -> Span:
        span = self._open.pop(sid)
        span.end = self.clock()
        span.args.update(args)
        self.spans.append(span)
        return span

    def emit(
        self, name: str, *, cat: str = "", tid: int = 0,
        start: float, end: float, **args,
    ) -> Span:
        """Record an already-measured interval (no open/close pair)."""
        span = Span(
            name=name, cat=cat, tid=tid, start=start, end=end,
            args=dict(args),
        )
        self.spans.append(span)
        return span

    def thread_name(self, tid: int, name: str) -> None:
        """Name a Chrome-trace track (idempotent)."""
        self._thread_names[tid] = name

    # -- inspection ----------------------------------------------------------
    @property
    def open_count(self) -> int:
        return len(self._open)

    def open_spans(self) -> list[Span]:
        return list(self._open.values())

    def count(self, name: str | None = None) -> int:
        """Closed spans, optionally by name — what the reconciliation
        tests compare against ``SchedulerTrace`` decision counts and
        the registry counters."""
        if name is None:
            return len(self.spans)
        return sum(1 for s in self.spans if s.name == name)

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        if self._open:
            raise RuntimeError(
                f"clear() with {len(self._open)} spans still open"
            )
        self.spans.clear()

    # -- export --------------------------------------------------------------
    def _t0(self) -> float:
        return min((s.start for s in self.spans), default=0.0)

    def to_events(self) -> list[dict]:
        """Chrome ``trace_event`` dicts (``ph: "X"`` complete events,
        microsecond timestamps rebased to the earliest span, plus
        ``thread_name`` metadata events)."""
        t0 = self._t0()
        events: list[dict] = [
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 0,
                "tid": tid,
                "args": {"name": name},
            }
            for tid, name in sorted(self._thread_names.items())
        ]
        for s in self.spans:
            events.append(
                {
                    "ph": "X",
                    "name": s.name,
                    "cat": s.cat or "obs",
                    "pid": 0,
                    "tid": s.tid,
                    "ts": (s.start - t0) * 1e6,
                    "dur": s.duration * 1e6,
                    "args": s.args,
                }
            )
        return events

    def to_chrome_trace(self, path: str) -> None:
        """Write a Perfetto-loadable ``{"traceEvents": [...]}`` file."""
        doc = {
            "traceEvents": self.to_events(),
            "displayTimeUnit": "ms",
            "otherData": {"schema": EVENTS_SCHEMA},
        }
        with open(path, "w") as f:
            json.dump(doc, f)

    def to_jsonl(self, path: str) -> None:
        """One span per line: ``{"name", "cat", "tid", "start", "end",
        "dur", "args"}`` with raw clock timestamps (not rebased)."""
        with open(path, "w") as f:
            for s in self.spans:
                f.write(
                    json.dumps(
                        {
                            "name": s.name,
                            "cat": s.cat,
                            "tid": s.tid,
                            "start": s.start,
                            "end": s.end,
                            "dur": s.duration,
                            "args": s.args,
                        },
                        sort_keys=True,
                    )
                    + "\n"
                )
