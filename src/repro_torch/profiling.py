"""Per-phase profile of a run, shared by the launch CLIs (``--profile``),
and the device time of a run by category of kernel."""

from __future__ import annotations

import bisect
import re

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["print_profile", "device_time_by_category"]


def print_profile(run, prefix: str, top: int = 8) -> None:
    """Run ``run()`` under torch.profiler and print, for each phase (a
    ``record_function`` range whose name starts with ``prefix``), its
    host time, the device time of the kernels and copies that ran inside
    it (their ratio is the device's busy share in that phase), and its
    top kernels by device time.  A phase ends in a synchronize, so every
    device event that a phase caused starts inside its host range."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()
    # The profiler's raw events: building its FunctionEvent tree
    # (``prof.events()``) takes tens of seconds for a run of a few
    # hundred thousand operator events, reading them takes a fraction.
    events = prof.profiler.kineto_results.events()
    phases = sorted(
        (e for e in events
         if e.name().startswith(prefix) and e.device_type() == DeviceType.CPU),
        key=lambda e: e.start_ns(),
    )
    device = [
        e for e in events
        if e.device_type() == DeviceType.CUDA and not e.name().startswith(prefix)
    ]
    for ph in phases:
        lo, hi = ph.start_ns(), ph.start_ns() + ph.duration_ns()
        per_kernel: dict[str, list] = {}
        for e in device:
            if lo <= e.start_ns() < hi:
                acc = per_kernel.setdefault(e.name(), [0.0, 0])
                acc[0] += e.duration_ns() / 1e3
                acc[1] += 1
        busy = sum(us for us, _ in per_kernel.values())
        host = ph.duration_ns() / 1e3
        print(f"[profile] {ph.name()}: host {host / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / host if host else 0:.1f}%)")
        ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
        for name, (us, n) in ranked[:top]:
            print(f"[profile]   {us / 1e3:9.3f} ms {100 * us / busy if busy else 0:5.1f}% "
                  f"x{n:<6d} {name[:100]}")


def device_time_by_category(run, categories: dict[str, str],
                            ranges: dict[str, str] | None = None,
                            other: str = "other"):
    """Run ``run()`` under torch.profiler and sum the device time of its
    kernels and copies by category: ``({category: ms}, {category: count},
    busy ms, {category: [(name, ms, count), ...] by ms})``.

    A device event goes to the category of ``ranges`` (category ->
    ``record_function`` name) whose host range saw the operator that
    launched it (matched through the profiler's correlation ids, so a
    kernel that runs after its range ended on the host still counts there),
    or whose range saw the forward operator of the autograd node that
    launched it (matched through the node's sequence number and forward
    thread: the backward of what ran inside a range counts there too);
    else to the first category of ``categories`` (category -> regex) that
    matches its name; else to ``other``.  The ranges' own annotation
    events on the device timeline are not counted."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    launched_at = {e.correlation_id(): e.start_ns() for e in cpu if e.correlation_id()}
    annotations = {e.name() for e in cpu if e.is_user_annotation()}
    spans = [(cat, e.start_ns(), e.start_ns() + e.duration_ns())
             for cat, name in (ranges or {}).items() for e in cpu if e.name() == name]
    in_span = _span_lookup(spans)
    backward = _backward_categories(cpu, in_span) if spans else {}
    patterns = [(cat, re.compile(rx)) for cat, rx in categories.items()]
    order = [*(ranges or {}), *categories, other]
    ms, count = dict.fromkeys(order, 0.0), dict.fromkeys(order, 0)
    names: dict[str, dict[str, list]] = {c: {} for c in order}
    for e in events:
        # a record_function range also shows on the device timeline as a
        # user annotation spanning its kernels: not device time of its own
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.name() in annotations):
            continue
        t = launched_at.get(e.linked_correlation_id())
        cat = backward.get(e.linked_correlation_id())
        if cat is None and t is not None:
            cat = in_span(t)
        if cat is None:
            cat = next((c for c, rx in patterns if rx.search(e.name())), other)
        ms[cat] += e.duration_ns() / 1e6
        count[cat] += 1
        acc = names[cat].setdefault(e.name(), [0.0, 0])
        acc[0] += e.duration_ns() / 1e6
        acc[1] += 1
    top = {c: sorted(((n, t, k) for n, (t, k) in d.items()), key=lambda r: -r[1])
           for c, d in names.items()}
    return ms, count, sum(ms.values()), top


_NODE = "autograd::engine::evaluate_function: "


def _span_lookup(spans):
    """``t -> the first category of spans ((category, start, end), grouped
    by category) with a span holding t, or None``, by bisection: a run of a
    million operators meets each of its events once."""
    tables = {}
    for cat, lo, hi in spans:
        tables.setdefault(cat, []).append((lo, hi))
    index = []
    for cat, rows in tables.items():
        rows.sort()
        reach, top = [], float("-inf")  # the furthest end of the spans so far
        for _, hi in rows:
            top = max(top, hi)
            reach.append(top)
        index.append((cat, [lo for lo, _ in rows], reach))

    def find(t):
        for cat, starts, reach in index:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and reach[i] > t:
                return cat
        return None

    return find


def _backward_categories(cpu, in_span) -> dict:
    """{correlation id of a launch: category} for the launches whose
    innermost enclosing autograd-recorded operator (sequence number >= 0,
    on the launching thread) is the backward node of a forward operator
    that ran inside a span of a category (``in_span``, of
    :func:`_span_lookup`).  A node shows
    as ``evaluate_function: XBackward0`` around ``XBackward0``, both with
    the node's sequence number; the operators inside run without grad
    (sequence number -1), those of a remat recompute with grad."""
    forward = {}
    for e in cpu:
        if e.sequence_nr() >= 0 and not e.name().startswith(_NODE):
            cat = in_span(e.start_ns())
            if cat is not None:
                forward.setdefault((e.sequence_nr(), e.start_thread_id()), cat)
    if not forward:
        return {}
    # per thread, in time order: the recorded operators (they nest, so a
    # stack holds the open ones) and the launches
    items = []
    for e in cpu:
        if e.sequence_nr() >= 0:
            items.append((e.start_thread_id(), e.start_ns(), 0, e))
        elif e.correlation_id():
            items.append((e.start_thread_id(), e.start_ns(), 1, e))
    items.sort(key=lambda it: it[:3])
    out, stack, thread = {}, [], None  # stack: (end, node key or None)
    for tid, t, kind, e in items:
        if tid != thread:
            stack, thread = [], tid
        while stack and stack[-1][0] <= t:
            stack.pop()
        if kind == 0:
            key = None
            if e.name().startswith(_NODE):
                key = (e.sequence_nr(), e.fwd_thread_id())
            elif stack and stack[-1][1] and stack[-1][1][0] == e.sequence_nr():
                key = stack[-1][1]  # the node's own event inside evaluate_function
            stack.append((e.start_ns() + e.duration_ns(), key))
        elif stack and stack[-1][1] in forward:
            out[e.correlation_id()] = forward[stack[-1][1]]
    return out
