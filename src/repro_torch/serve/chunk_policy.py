"""Chunk scheduling policies for the continuous elasticity engine.

The continuous engine (:class:`repro_torch.serve.elasticity_service.
ElasticityService`) advances each in-flight batch by a bounded chunk of
PCG iterations per ``step()``.  The chunk length is the serving layer's
hot-path knob: too long and near-converged rows idle inside the chunk
(wasted iterations) while freed slots wait for the chunk boundary to be
refilled; too short and the host pays a retire/refill round-trip per
handful of iterations.  Retire cadence varies strongly with the
polynomial degree and the tolerance mix of the in-flight batch, so a
fixed default is the wrong length for most mixes.

This module makes the choice a *policy*:

* :class:`FixedChunkPolicy` — today's behavior, bit-for-bit: every
  chunk has the same length (``chunk_iters``).
* :class:`AdaptiveChunkPolicy` — predict the next retirement from the
  observed iterations-to-retire cadence of the in-flight mix (a ring
  buffer of recent retire cadences) and chunk up to exactly that point,
  clamped to ``[min_chunk, max_chunk]``.
* :class:`ShardAdaptiveChunkPolicy` — with the scenario axis sharded, a
  retire only frees *device-aligned* capacity when its shard drains, so
  this policy (a) computes the cadence estimate per device and chunks to
  the earliest per-device retirement, and (b) places refills on the
  device with the fewest live rows, keeping shards evenly drained.

THE invariant every policy must preserve: **scheduling never changes
numerics**.  ``bpcg`` chunk boundaries are bitwise invisible to the
iteration and batch rows never couple, so any policy yields the same
iteration counts, convergence flags and (to machine precision)
solutions as the fixed default — only *when* rows retire and refill
differs.  A policy whose decision sequence coincides with fixed (e.g.
adaptive clamped to ``min_chunk == max_chunk``) reproduces it bitwise;
genuinely different schedules route rows through different bucket
shapes, whose reductions may round differently by ~1 ulp.

Every decision is recorded in a :class:`SchedulerTrace` — the observed
cadence, the chosen chunk, the refill placements and (after the chunk
ran) the per-row iterations consumed — so decisions are deterministic
and replayable: :meth:`SchedulerTrace.replay` re-derives every chunk
choice from the recorded observations alone.
:func:`simulate_cadence_trace` drives a policy against a recorded or
synthetic cadence trace with **no solver in the loop**, which is what
the deterministic scheduler-trace harness builds on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

__all__ = [
    "HISTORY_LEN",
    "ChunkObservation",
    "ChunkPolicy",
    "FixedChunkPolicy",
    "AdaptiveChunkPolicy",
    "ShardAdaptiveChunkPolicy",
    "ChunkDecision",
    "RefillPlacement",
    "SchedulerTrace",
    "check_chunk_bounds",
    "make_chunk_policy",
    "simulate_cadence_trace",
]

# Ring-buffer length of the per-flight retire history.  Shared by the
# service and the trace simulator so harness decisions match production.
HISTORY_LEN = 32


def _check_positive_int(name: str, v, where: str) -> None:
    """ONE spelling of "must be an integer >= 1" for every policy
    parameter, so the message always names exactly the parameter the
    caller passed (never a derived value)."""
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
        raise TypeError(
            f"{where}: {name} must be an integer >= 1, got {v!r}"
        )
    if v < 1:
        raise ValueError(f"{where}: {name} must be >= 1, got {v}")


def check_chunk_bounds(min_chunk, max_chunk, where: str) -> None:
    """Policy-bound validation (the generalization of the old
    ``chunk_iters < 1`` check): both bounds must be integers >= 1 and
    ordered.  Error messages name the offending bound and value."""
    _check_positive_int("min_chunk", min_chunk, where)
    _check_positive_int("max_chunk", max_chunk, where)
    if min_chunk > max_chunk:
        raise ValueError(
            f"{where}: min_chunk ({min_chunk}) must be <= "
            f"max_chunk ({max_chunk})"
        )


@dataclasses.dataclass(frozen=True)
class ChunkObservation:
    """What a policy sees when choosing the next chunk for one flight.

    Everything here is plain host data — no device arrays — so a
    recorded observation replays bit-for-bit with no solver in the loop.

    ``live_iters[i]`` is live row i's iteration count since its
    (re)start, ``live_devices[i]`` the device that owns its shard (all
    zeros single-device), and ``history`` the flight's ring buffer of
    recent retire cadences (total iterations at retirement, oldest
    first)."""

    live_iters: tuple[int, ...]
    live_devices: tuple[int, ...]
    history: tuple[int, ...]
    bucket: int
    n_devices: int = 1


class ChunkPolicy:
    """Base policy: bounds + the two scheduling decisions.

    ``chunk_for`` picks the next chunk length from an observation;
    ``placement`` orders the free slots refills should fill (default:
    ascending slot index — exactly the pre-policy engine behavior).
    Both must be pure functions of their arguments: the service records
    every observation, and the trace harness replays them."""

    name = "chunk-policy"

    def __init__(self, min_chunk: int, max_chunk: int):
        check_chunk_bounds(min_chunk, max_chunk, f"{self.name} policy")
        self.min_chunk = int(min_chunk)
        self.max_chunk = int(max_chunk)

    def clamp(self, k: int) -> int:
        return max(self.min_chunk, min(self.max_chunk, int(k)))

    def chunk_for(self, obs: ChunkObservation) -> int:
        raise NotImplementedError

    def placement(
        self,
        free_slots: Sequence[int],
        slot_devices: Sequence[int],
        live_devices: Sequence[int],
    ) -> list[int]:
        """Order in which ``free_slots`` should be refilled.
        ``slot_devices[s]`` maps ANY slot index to its owning device;
        ``live_devices`` lists the devices of currently-live rows."""
        del slot_devices, live_devices
        return list(free_slots)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"{type(self).__name__}(min_chunk={self.min_chunk}, "
            f"max_chunk={self.max_chunk})"
        )


class FixedChunkPolicy(ChunkPolicy):
    """Every chunk has the same length — the pre-policy engine,
    bit-for-bit (same chunk choices, same ascending-slot refills)."""

    name = "fixed"

    def __init__(self, chunk_iters: int):
        _check_positive_int("chunk_iters", chunk_iters, "fixed policy")
        super().__init__(int(chunk_iters), int(chunk_iters))

    def chunk_for(self, obs: ChunkObservation) -> int:
        del obs
        return self.min_chunk


def _next_retire_distance(
    live_iters: Sequence[int], history: Sequence[int]
) -> int | None:
    """Predicted iterations until the next retirement: for each live row
    at iteration ``it``, the nearest historical cadence strictly ahead of
    it (``h - it`` for the smallest ``h > it``); the minimum over rows.
    None when the history offers no prediction (empty, or every cadence
    already behind every live row)."""
    best: int | None = None
    for it in live_iters:
        ahead = [h - it for h in history if h > it]
        if ahead:
            d = min(ahead)
            best = d if best is None else min(best, d)
    return best


class AdaptiveChunkPolicy(ChunkPolicy):
    """Chunk to the predicted next retirement of the in-flight mix.

    The estimate comes from the flight's retire-history ring buffer:
    rows retiring at ~c iterations teach the policy to cut chunks at the
    c-iteration boundary, so a near-converged row neither idles inside a
    long chunk nor delays the refill of its slot.  With no usable
    history the policy falls back to ``default_chunk`` (the fixed
    default), and every choice is clamped to ``[min_chunk, max_chunk]``
    — so ``min_chunk == max_chunk`` reproduces
    :class:`FixedChunkPolicy` decision-for-decision."""

    name = "adaptive"

    def __init__(
        self,
        min_chunk: int = 1,
        max_chunk: int = 32,
        default_chunk: int = 8,
    ):
        super().__init__(min_chunk, max_chunk)
        _check_positive_int(
            "default_chunk", default_chunk, f"{self.name} policy"
        )
        self.default_chunk = int(default_chunk)

    def chunk_for(self, obs: ChunkObservation) -> int:
        d = _next_retire_distance(obs.live_iters, obs.history)
        return self.clamp(self.default_chunk if d is None else d)


class ShardAdaptiveChunkPolicy(AdaptiveChunkPolicy):
    """Adaptive chunking + placement driven by the per-device live mix.

    With the scenario axis sharded, bucket capacity is device-aligned: a
    retire only lets the bucket shrink (or a refill land without
    growing it) when its *shard* drains.  Two shard-aware choices:

    * **chunk length** — the cadence estimate runs per device over that
      device's live rows; the chunk stops at the earliest per-device
      predicted retirement (devices whose rows have no usable history
      contribute the fixed default), so no shard sits on a retired row
      waiting for another shard's long chunk.
    * **refill placement** — freed slots are filled on the device with
      the fewest live rows first (ties to the lower device, then the
      lower slot index), keeping shards evenly loaded so retires free
      whole shards as early as possible.

    Single-device this degenerates to :class:`AdaptiveChunkPolicy`
    decisions with the same ascending-slot placement."""

    name = "shard-adaptive"

    def chunk_for(self, obs: ChunkObservation) -> int:
        per_dev: dict[int, list[int]] = {}
        for it, dev in zip(obs.live_iters, obs.live_devices):
            per_dev.setdefault(dev, []).append(it)
        if not per_dev:
            return self.clamp(self.default_chunk)
        dists = []
        for dev in sorted(per_dev):
            d = _next_retire_distance(per_dev[dev], obs.history)
            dists.append(self.default_chunk if d is None else d)
        return self.clamp(min(dists))

    def placement(
        self,
        free_slots: Sequence[int],
        slot_devices: Sequence[int],
        live_devices: Sequence[int],
    ) -> list[int]:
        load: dict[int, int] = {}
        for dev in live_devices:
            load[dev] = load.get(dev, 0) + 1
        remaining = list(free_slots)
        order: list[int] = []
        while remaining:
            slot = min(
                remaining,
                key=lambda s: (
                    load.get(slot_devices[s], 0),
                    slot_devices[s],
                    s,
                ),
            )
            remaining.remove(slot)
            order.append(slot)
            dev = slot_devices[slot]
            load[dev] = load.get(dev, 0) + 1
        return order


_POLICIES = {
    "fixed": FixedChunkPolicy,
    "adaptive": AdaptiveChunkPolicy,
    "shard-adaptive": ShardAdaptiveChunkPolicy,
}


def make_chunk_policy(
    spec,
    *,
    chunk_iters: int = 8,
    min_chunk: int | None = None,
    max_chunk: int | None = None,
) -> ChunkPolicy:
    """Build a policy from its CLI/constructor spelling.

    ``spec`` is None or ``"fixed"`` (→ :class:`FixedChunkPolicy` at
    ``chunk_iters``, the pre-policy default), ``"adaptive"``,
    ``"shard-adaptive"``, or an already-built :class:`ChunkPolicy`
    (returned as-is; a prebuilt policy carries its own chunk
    configuration, so ``chunk_iters`` does not apply to it — but it is
    still validated, so a bad value cannot hide behind one).  For the
    adaptive policies ``chunk_iters`` is the no-history fallback and
    the bounds default to ``[1, 4 * chunk_iters]``.  The bounds only
    exist on the adaptive policies, so passing one with a fixed (or
    prebuilt) policy is an error, not a silent no-op."""
    if isinstance(spec, ChunkPolicy) or spec is None or spec == "fixed":
        if min_chunk is not None or max_chunk is not None:
            name = spec.name if isinstance(spec, ChunkPolicy) else "fixed"
            raise ValueError(
                f"min_chunk/max_chunk only apply to the adaptive "
                f"policies, but the chunk policy is {name!r} — drop the "
                f"bounds or pick 'adaptive'/'shard-adaptive' (the fixed "
                f"chunk length is chunk_iters)"
            )
        if isinstance(spec, ChunkPolicy):
            _check_positive_int(
                "chunk_iters", chunk_iters, f"{spec.name} policy"
            )
            return spec
        return FixedChunkPolicy(chunk_iters)
    if spec in ("adaptive", "shard-adaptive"):
        # Validate chunk_iters BEFORE deriving the default upper bound
        # from it, so a bad chunk_iters is blamed on chunk_iters — not
        # on a max_chunk value the caller never passed.
        _check_positive_int("chunk_iters", chunk_iters, f"{spec} policy")
        lo = 1 if min_chunk is None else min_chunk
        hi = 4 * chunk_iters if max_chunk is None else max_chunk
        return _POLICIES[spec](lo, hi, default_chunk=chunk_iters)
    raise ValueError(
        f"unknown chunk policy {spec!r} (expected one of "
        f"{sorted(_POLICIES)} or a ChunkPolicy instance)"
    )


# -- scheduler trace ---------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RefillPlacement:
    """One refill decision: which ticket landed in which slot, and the
    device that owns that slot's shard."""

    ticket: int
    slot: int
    device: int


@dataclasses.dataclass
class ChunkDecision:
    """One scheduling decision (one dispatched chunk) and its outcome.

    ``observation``/``chunk``/``refills`` are written when the chunk is
    dispatched; ``consumed`` (per-bucket-row iterations actually
    executed) and ``wasted`` are filled in after the chunk returns.
    ``wasted`` counts slot-iterations live rows idled inside the chunk:
    rows that retired (or froze) before the chunk's last executed
    iteration sat on capacity a shorter chunk would have freed."""

    step: int
    key: Any
    policy: str
    bucket: int
    observation: ChunkObservation
    chunk: int
    refills: tuple[RefillPlacement, ...] = ()
    live_slots: tuple[int, ...] = ()
    consumed: tuple[int, ...] = ()
    wasted: int = 0


def wasted_iterations(
    consumed: Sequence[int], live_slots: Sequence[int]
) -> int:
    """Slot-iterations wasted by one chunk: the chunk ran for
    ``max(consumed)`` iterations (rows still active at the end consumed
    every one of them), so each live row that stopped earlier idled for
    the difference.  Rows inactive at dispatch (consumed == 0) never
    entered the chunk and are not counted; padding rows are excluded by
    passing only live slots."""
    live = [int(consumed[i]) for i in live_slots]
    steps_run = max((c for c in live), default=0)
    return sum(steps_run - c for c in live if c > 0)


class SchedulerTrace:
    """Record of the scheduling decisions of a service (or a
    simulation).  Decisions are pure host data, so the trace is the
    replayable ground truth the harness and the stats counters are
    checked against.

    The record is BOUNDED: only the most recent ``maxlen`` decisions are
    retained (default 4096 — the same kind of cap as the retire-history
    ring buffer), so a long-lived service cannot grow without bound.
    ``summary()``/``replay()`` therefore cover the retained window; the
    cumulative ``ElasticityService.stats`` counters are independent of
    the trimming (pass ``maxlen=None`` for an unbounded record)."""

    def __init__(self, maxlen: int | None = 4096) -> None:
        if maxlen is not None and maxlen < 1:
            raise ValueError(f"trace maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self.decisions: list[ChunkDecision] = []

    def append(self, decision: ChunkDecision) -> None:
        self.decisions.append(decision)
        if self.maxlen is not None and len(self.decisions) > self.maxlen:
            del self.decisions[: len(self.decisions) - self.maxlen]

    def clear(self) -> None:
        """Drop recorded decisions (the aggregate service counters are
        cumulative and unaffected) — e.g. between workloads."""
        self.decisions.clear()

    def __len__(self) -> int:
        return len(self.decisions)

    def chunks(self) -> list[int]:
        return [d.chunk for d in self.decisions]

    def replay(self, policy: ChunkPolicy) -> list[int]:
        """Re-derive every chunk choice from the recorded observations.
        A policy is deterministic iff this equals :meth:`chunks` for the
        policy that produced the trace."""
        return [policy.chunk_for(d.observation) for d in self.decisions]

    def summary(self) -> dict:
        """Aggregate scheduler stats, in the same vocabulary as
        ``ElasticityService.stats``: chunks dispatched, mean chosen
        chunk length, wasted slot-iterations, refills placed."""
        n = len(self.decisions)
        return {
            "chunks": n,
            "mean_chunk": (
                float(np.mean([d.chunk for d in self.decisions]))
                if n
                else 0.0
            ),
            "wasted_iters": int(sum(d.wasted for d in self.decisions)),
            "refills": int(sum(len(d.refills) for d in self.decisions)),
        }


# -- solver-free trace simulation --------------------------------------------
def simulate_cadence_trace(policy: ChunkPolicy, trace: dict) -> SchedulerTrace:
    """Drive ``policy`` against a recorded/synthetic cadence trace with
    no solver in the loop — the deterministic scheduler-trace harness.

    ``trace`` is a plain dict (the ``tests/data/sched_traces/*.json``
    format)::

        {
          "bucket": 8,          # fixed slot count of the abstract flight
          "n_devices": 2,       # bucket must be a device multiple
          "requests": [[arrival_step, iters_to_retire], ...]
        }

    The abstract engine mirrors the service's scheduling loop on one
    flight with a fixed bucket: each step retires rows whose recorded
    iterations-to-retire have been consumed (appending the cadence to
    the shared history ring buffer), refills free slots from the arrived
    queue in the policy's placement order, asks the policy for the next
    chunk length, and advances every live row by ``min(chunk, max
    remaining)`` — the same early-exit the ``bpcg`` loop has.
    Rows map to devices in contiguous shards of ``bucket / n_devices``
    rows, matching axis-0 scenario sharding.  Returns the full
    :class:`SchedulerTrace` (decisions, consumed, wasted)."""
    from collections import deque

    bucket = int(trace["bucket"])
    n_devices = int(trace.get("n_devices", 1))
    if bucket < 1 or n_devices < 1 or bucket % n_devices:
        raise ValueError(
            f"trace: bucket ({bucket}) must be a positive multiple of "
            f"n_devices ({n_devices})"
        )
    requests = [
        (int(a), int(need)) for a, need in trace["requests"]
    ]
    for i, (a, need) in enumerate(requests):
        if a < 0 or need < 1:
            raise ValueError(
                f"trace request {i}: arrival_step must be >= 0 and "
                f"iters_to_retire >= 1, got {(a, need)}"
            )
    slot_devices = [s // (bucket // n_devices) for s in range(bucket)]

    # slot -> [ticket, iters_done, iters_to_retire] or None
    slots: list[list[int] | None] = [None] * bucket
    queue = deque(
        (t, a, need) for t, (a, need) in enumerate(requests)
    )
    history: deque[int] = deque(maxlen=HISTORY_LEN)
    out = SchedulerTrace()
    step = 0
    while True:
        # retire
        for s, row in enumerate(slots):
            if row is not None and row[1] >= row[2]:
                history.append(row[2])
                slots[s] = None
        # admit (policy placement over the arrived queue)
        free = [s for s, r in enumerate(slots) if r is None]
        arrived = [q for q in queue if q[1] <= step]
        live_devs = [
            slot_devices[s] for s, r in enumerate(slots) if r is not None
        ]
        order = policy.placement(free, slot_devices, live_devs)
        refills = []
        for (ticket, _, need), s in zip(arrived, order):
            slots[s] = [ticket, 0, need]
            refills.append(
                RefillPlacement(ticket=ticket, slot=s, device=slot_devices[s])
            )
            queue.remove((ticket, _, need))
        live = [s for s, r in enumerate(slots) if r is not None]
        if not live:
            if not queue:
                return out
            step += 1  # idle until the next arrival
            continue
        obs = ChunkObservation(
            live_iters=tuple(slots[s][1] for s in live),
            live_devices=tuple(slot_devices[s] for s in live),
            history=tuple(history),
            bucket=bucket,
            n_devices=n_devices,
        )
        k = policy.chunk_for(obs)
        assert policy.min_chunk <= k <= policy.max_chunk
        steps_run = min(k, max(slots[s][2] - slots[s][1] for s in live))
        consumed = [0] * bucket
        for s in live:
            consumed[s] = min(slots[s][2] - slots[s][1], steps_run)
            slots[s][1] += consumed[s]
        out.append(
            ChunkDecision(
                step=step,
                key="trace",
                policy=policy.name,
                bucket=bucket,
                observation=obs,
                chunk=k,
                refills=tuple(refills),
                live_slots=tuple(live),
                consumed=tuple(consumed),
                wasted=wasted_iterations(consumed, live),
            )
        )
        step += 1
