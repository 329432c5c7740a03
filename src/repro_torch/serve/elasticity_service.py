"""Batched elasticity solve service on the card.

Requests describing parameterized elasticity scenarios (materials,
traction, tolerance) arrive in a queue, are grouped by *discretization
key* ``(p, n_h_refine, coarse_mesh.shape, ...)``, and each group is
solved by batched GMG-PCG (:class:`repro_torch.solvers.batched.
BatchedGMGSolver`), whose operator applies run the PAop kernel on the
card.  Two scheduling policies share the solver cache and the reports:

* **continuous batching** (``submit`` / ``step`` / ``drain``) — each
  in-flight key holds a resumable :class:`~repro_torch.solvers.batched.
  BpcgState`; every ``step`` retires the rows that stopped in the last
  chunk (their :class:`SolveReport`\\ s become drainable), refills the
  freed slots from the queue by resetting *just those state rows*,
  re-buckets the batch to the smallest sufficient size, and advances it
  by one bounded chunk of PCG iterations.  One slow scenario no longer
  holds a whole generation's rows frozen.

* **generational batching** (``solve``) — drain everything in fixed
  batches; kept for one-shot workloads and as the baseline the
  continuous path is compared against.

Shared machinery:

* solvers (hierarchy, transfers, traction pattern) per key live in an
  LRU cache that never evicts a solver with rows in flight;
* **bucketed padding**: batches are padded to the smallest sufficient
  bucket (1/2/4/.../max_batch) with zero-traction rows, born converged
  and never surfaced to callers; real zero-RHS requests are flagged
  ``born_converged``;
* **materials** are attribute dicts or per-element ``(lam_e, mu_e)``
  pairs on the fine mesh, folded into (S, nelem) fields on admission;
  a refill whose folded fields match a prepared row (content digest,
  confirmed bitwise) copies that row's prep instead of paying
  ``prepare``;
* **chunk scheduling** (how many iterations each continuous chunk runs,
  which free slot a refill lands in) is a
  :class:`~repro_torch.serve.chunk_policy.ChunkPolicy` — ``fixed``,
  ``adaptive`` or ``shard-adaptive`` — recorded in ``trace``; policies
  never change numerics;
* **precision fallback**: rows a reduced-precision flight flags as
  stagnated are re-queued onto ``f64`` with the same ticket;
* **observability**: every counter lives on a
  :class:`repro_torch.obs.metrics.MetricsRegistry` labeled by
  ``(p, refine, policy, devices, precision)`` (``stats`` is a read-only
  view), latency and queue wait feed registry histograms, and an
  attached :class:`repro_torch.obs.spans.SpanRecorder` records the
  request lifecycle with device-fenced per-chunk timing.

The service holds to the reference package's semantics, counter names
and span taxonomy.  Host traffic: one device-to-host transfer per
flight per retire pass (the six (S,) convergence vectors and the last
chunk's consumed vector, stacked), one per admitted request (its folded
materials, which the digest hashes) and one per kept solution.

Fault tolerance: ``attach_watchdog`` arms a step hang detector, and
:class:`repro_torch.serve.recovery.ServiceRecovery` checkpoints and
restores the in-flight state.

Scenario sharding: with ``mesh`` set (a sequence of devices, repeats
allowed, or an int: the first n cards, or n virtual CPU devices with
``device="cpu"``), every solver the service builds splits its batch rows
over the mesh (:mod:`repro_torch.distributed.sharding`).  Buckets round
up to a multiple of the device count, reports count the device padding
rows in ``padded_rows``, and the retire pass gathers each flight's
(S,) vectors onto the first device before its one transfer.  The
reference's Pallas-lane arguments have no counterpart: ``assembly``
picks the kernel (``"paop_cuda"``) or its plain version (``"paop"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.core.geometry import (
    MATERIALS_BEAM,
    check_material_dict,
    check_material_fields,
)
from repro_torch.core.precision import PrecisionPolicy, resolve_precision
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.distributed.sharding import (
    gather_scenario,
    normalize_scenario_mesh,
    scenario_row_devices,
)
from repro_torch.fem.mesh import HexMesh, beam_hex
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.chunk_policy import (
    HISTORY_LEN,
    ChunkDecision,
    ChunkObservation,
    RefillPlacement,
    SchedulerTrace,
    make_chunk_policy,
    wasted_iterations,
)
from repro_torch.solvers.batched import BatchedGMGSolver, BpcgState

__all__ = ["SolveRequest", "SolveReport", "ElasticityService"]

# Help text for the service counter families.  The keys double as the
# ``ElasticityService.stats`` vocabulary: each maps to the
# ``service_<key>_total`` counter family on the registry.
_STAT_HELP = {
    "cache_hits": "Solver LRU cache hits.",
    "cache_misses": "Solver LRU cache misses (hierarchy + program builds).",
    "generations": "Generational batches solved.",
    "chunks": "Continuous chunks dispatched.",
    "chunk_iters_dispatched": "PCG iterations dispatched across chunks.",
    "wasted_iters": "Dispatched slot-iterations no live row consumed.",
    "refills": "Freed slots refilled from the queue.",
    "rebuckets": "In-flight state re-bucketings.",
    "prep_calls": "prepare() calls (power iterations + refactorization).",
    "prep_row_copies": "Prep rows reused via content-digest match.",
    "precision_fallbacks": (
        "Rows a reduced-precision flight re-queued onto the f64 path "
        "after stagnation detection."
    ),
    # Recovery counters, labeled (policy, devices): written by
    # repro_torch.serve.recovery and the step watchdog.
    "checkpoints_written": (
        "Recovery checkpoints committed to disk (atomic renames)."
    ),
    "restores": "Service restores from a recovery checkpoint.",
    "watchdog_fires": "step() calls the watchdog flagged past timeout.",
}
# Host dtype of each device vector the service fetches.
_HOST_DTYPE = {
    torch.float64: np.float64, torch.float32: np.float32,
    torch.int32: np.int32, torch.bool: np.bool_,
}


def _to_host(vecs: list) -> list[np.ndarray]:
    """Same-length 1-D device vectors in ONE device-to-host transfer:
    gathered onto the first one's device when split over a scenario mesh,
    stacked as f64, which holds every f32, int32 and bool value exactly,
    and each cast back to its own dtype on the host."""
    vecs = gather_scenario(vecs)
    dev = vecs[0].device
    host = torch.stack([v.to(dev, torch.float64) for v in vecs]).cpu().numpy()
    return [row.astype(_HOST_DTYPE[v.dtype]) for v, row in zip(vecs, host)]


class _StatsView(Mapping):
    """Read-only view of the service counters: the ``_STAT_HELP`` keys,
    each summed across every label set of its registry family, as
    ints.  Writes go through the registry, never here."""

    _KEYS = tuple(_STAT_HELP)

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, key: str) -> int:
        if key not in self._KEYS:
            raise KeyError(key)
        return int(self._registry.total(f"service_{key}_total"))

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __repr__(self) -> str:
        return repr(dict(self))


@dataclasses.dataclass
class SolveRequest:
    """One parameterized beam-benchmark scenario.

    ``materials`` (``None`` = the paper's beam materials) is an
    attribute -> (lambda, mu) dict, e.g. ``{1: (50.0, 50.0), 2: (1.0,
    1.0)}``, or a ``(lam_e, mu_e)`` pair of per-element arrays of shape
    (nelem_fine,) with ``nelem_fine = coarse_mesh.nelem * 8**refine``.
    Both forms are validated at ``submit()``.  ``rel_tol`` is the
    MFEM-style relative residual tolerance; ``keep_solution`` attaches
    the (nscalar, 3) solution to the report as a host numpy array.

    ``precision`` names the request's
    :class:`~repro_torch.core.precision.PrecisionPolicy` (``"f64"``,
    ``"f32"``, ``"mixed"``); ``None`` inherits the service default.  The
    policy is part of the flight/cache key and is recorded on the
    report; rows a reduced-precision flight flags as stagnated are
    re-queued (same ticket, original submit time) onto ``f64`` and
    their reports carry ``fallback=True``."""

    p: int = 2
    refine: int = 1
    materials: dict[int, tuple[float, float]] | tuple[Any, Any] | None = None
    traction: tuple[float, float, float] = (0.0, 0.0, -1e-2)
    rel_tol: float = 1e-6
    coarse_mesh: HexMesh | None = None
    keep_solution: bool = False
    precision: str | None = None


def _req_materials(req: SolveRequest):
    """The request's materials with the beam default applied."""
    return req.materials if req.materials is not None else MATERIALS_BEAM


def _material_digest(
    lam_row: np.ndarray, mu_row: np.ndarray, precision: str = "f64"
) -> bytes:
    """Content digest of one folded (lam_e, mu_e) row pair, with the
    precision-policy name folded in (prep computed at one policy's
    dtypes is not another's).  The continuous engine keys prep-row reuse
    on it and confirms a match bitwise against the snapshot."""
    h = hashlib.blake2b(digest_size=16)
    h.update(precision.encode())
    h.update(np.ascontiguousarray(lam_row))
    h.update(np.ascontiguousarray(mu_row))
    return h.digest()


@dataclasses.dataclass
class SolveReport:
    """Per-request outcome (one row of a batched solve).

    ``generation`` is the generation index for the generational path and
    the retiring chunk index for the continuous path; ``batch_size`` is
    the number of live (non-padding) rows sharing the batch when this
    request finished and ``padded_rows`` the batch's total rows;
    ``t_solve`` is the generation's time between device fences for the
    generational path and the request's admission-to-retirement latency
    for the continuous path.  ``ticket`` is the ``submit()`` ticket (-1
    on the generational path, which returns reports positionally)."""

    request: SolveRequest
    key: tuple
    iterations: int
    converged: bool
    final_rel_norm: float
    ndof: int
    batch_size: int
    generation: int
    cache_hit: bool
    t_setup: float
    t_solve: float
    born_converged: bool = False
    padded_rows: int = 0
    precision: str = "f64"
    fallback: bool = False
    ticket: int = -1
    x: Any = None


@dataclasses.dataclass
class _Slot:
    """A live batch row: which request occupies it and since when.

    ``t_submit`` carries the ticket's enqueue time so retirement can
    attribute queue wait; ``t_compute`` / ``t_padding`` accumulate this
    row's share of device-fenced chunk time and of its padding fraction
    (kept only while a fencing SpanRecorder is attached)."""

    ticket: int
    request: SolveRequest
    t_admit: float
    t_submit: float = 0.0
    t_compute: float = 0.0
    t_padding: float = 0.0


class _Flight:
    """In-flight continuous batch for one discretization key: the
    resumable solver state plus host-side slot bookkeeping."""

    def __init__(self, key, solver, cache_hit, t_setup, tid_base=0):
        self.key = key
        self.solver = solver
        self.cache_hit = cache_hit
        self.t_setup = t_setup
        # Chrome-trace track block: the flight's prep/chunk spans go on
        # ``tid_base``; slot i's queue_wait/solve spans on tid_base+1+i.
        self.tid_base = tid_base
        self.bucket = 0
        self.slots: list[_Slot | None] = []
        # Folded (bucket, nelem_fine) per-element material fields, on the
        # host (the digest hashes them).
        ne = solver.fine_space.nelem
        self.lam = np.zeros((0, ne))
        self.mu = np.zeros((0, ne))
        self.mat_digest = np.zeros((0,), dtype=object)
        self.tr = np.zeros((0, 3))
        self.tol = np.zeros((0,))
        self.state: BpcgState | None = None
        self.prep: dict | None = None
        # Materials each prep row was computed for (prep_valid rows
        # only), kept apart from lam/mu: a retiring row's prep stays
        # valid for its OLD materials until overwritten, so it can donate
        # its derived data to a refill with matching materials.
        self.prep_valid = np.zeros((0,), dtype=bool)
        self.prep_digest = np.zeros((0,), dtype=object)
        self.prep_lam = np.zeros((0, ne))
        self.prep_mu = np.zeros((0, ne))
        self.pending_reset: np.ndarray | None = None
        self.chunks = 0
        # Scheduling state of the chunk policies, all on the host: a
        # ring buffer of retire cadences and a per-row iteration mirror
        # advanced by the consumed vectors run_chunk returns.  The last
        # chunk's consumed vector stays on the device (pending_consumed)
        # until the next retire pass fetches it with the state.
        self.retire_history: deque[int] = deque(maxlen=HISTORY_LEN)
        self.row_iters = np.zeros((0,), dtype=np.int64)
        self.pending_refills: tuple[RefillPlacement, ...] = ()
        self.pending_consumed: torch.Tensor | None = None
        self.last_decision: ChunkDecision | None = None

    def live_rows(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]


class ElasticityService:
    """Queue + LRU-cached solvers + continuous/generational batching, on
    the card by default (``device="cpu"`` runs the plain PyTorch
    version)."""

    def __init__(
        self,
        *,
        max_batch: int = 8,
        cache_size: int = 4,
        assembly: str = "paop_cuda",
        dtype=None,
        precision: str | PrecisionPolicy | None = None,
        maxiter: int = 200,
        chunk_iters: int = 8,
        chunk_policy=None,
        min_chunk: int | None = None,
        max_chunk: int | None = None,
        mesh=None,
        registry: MetricsRegistry | None = None,
        spans=None,
        clock=time.perf_counter,
        device=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        self.mesh, self.n_shards = normalize_scenario_mesh(mesh, device)
        self.device = self.mesh[0] if self.mesh is not None else resolve_device(device)
        # What a fence waits for: every device of the mesh.
        self._devices = self.mesh or self.device
        self.max_batch = max_batch
        self.cache_size = cache_size
        self.assembly = assembly
        self.precision = resolve_precision(precision, dtype)
        self.dtype = self.precision.solve_dtype
        self.maxiter = maxiter
        self.chunk_iters = chunk_iters
        # Bad bounds (chunk_iters < 1, min_chunk > max_chunk) fail here,
        # with a message naming the parameter, not mid-flight.
        self.chunk_policy = make_chunk_policy(
            chunk_policy,
            chunk_iters=chunk_iters,
            min_chunk=min_chunk,
            max_chunk=max_chunk,
        )
        self.trace = SchedulerTrace()
        self._step_index = 0
        self._solvers: OrderedDict[tuple, BatchedGMGSolver] = OrderedDict()
        self._queue: list[tuple[int, SolveRequest]] = []
        self._flights: dict[tuple, _Flight] = {}
        self._completed: dict[int, SolveReport] = {}
        self._fallback_tickets: set[int] = set()
        self._next_ticket = 0
        self.clock = clock
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stats = _StatsView(self.registry)
        self.spans = None
        self.watchdog: StepWatchdog | None = None
        self._t_submit: dict[int, float] = {}
        self._next_flight_idx = 0
        if spans is not None:
            self.attach_spans(spans)

    # -- observability -------------------------------------------------------
    def attach_watchdog(self, timeout_s: float, on_timeout=None) -> StepWatchdog:
        """Arm a :class:`repro_torch.distributed.elastic.StepWatchdog` as
        a hang detector on ``step()``: a step exceeding ``timeout_s``
        increments the ``watchdog_fires`` counter (labeled policy/
        devices) and emits a ``watchdog_fire`` span on the engine track,
        then calls ``on_timeout(elapsed_s)`` if given (the escalation
        hook).  Returns the watchdog, whose ``timeouts``/``slowest`` the
        caller may read."""

        def fire(elapsed: float) -> None:
            self._inc_engine("watchdog_fires")
            if self.spans is not None:
                t = self.clock()
                self.spans.emit(
                    "watchdog_fire", cat="engine", tid=0, start=t, end=t,
                    elapsed_s=elapsed, step=self._step_index,
                )
            if on_timeout is not None:
                on_timeout(elapsed)

        self.watchdog = StepWatchdog(timeout_s, on_timeout=fire)
        return self.watchdog

    def attach_spans(self, recorder) -> None:
        """Install a :class:`repro_torch.obs.spans.SpanRecorder`.  With
        ``recorder.fence`` set, every continuous chunk is fenced with a
        device synchronize, separating host dispatch from device compute
        without fetching the deferred consumed vector.  With no recorder
        the service adds no fences and no per-chunk timing."""
        self.spans = recorder
        recorder.thread_name(0, "engine")

    def _labels(self, key: tuple) -> dict:
        """The uniform service label set for a flight key."""
        return {
            "p": key[0],
            "refine": key[1],
            "policy": self.chunk_policy.name,
            "devices": self.n_shards,
            "precision": key[-1],
        }

    def _inc_engine(self, stat: str) -> None:
        """A counter of the engine as a whole (recovery, the watchdog),
        labeled (policy, devices)."""
        self.registry.counter(
            f"service_{stat}_total", _STAT_HELP[stat],
            policy=self.chunk_policy.name, devices=self.n_shards,
        ).inc()

    def _inc(self, stat: str, key: tuple, n: int = 1) -> None:
        self.registry.counter(
            f"service_{stat}_total", _STAT_HELP[stat], **self._labels(key)
        ).inc(n)

    def _observe(self, name: str, help: str, key: tuple, v: float) -> None:
        self.registry.histogram(name, help, **self._labels(key)).observe(v)

    def latency_summary(
        self, qs: tuple[float, ...] = (0.5, 0.9, 0.99)
    ) -> dict[str, float]:
        """Request-latency quantiles merged across every label set (empty
        dict before any request finished)."""
        h = self.registry.merged_histogram("request_latency_seconds")
        if h is None or h.count == 0:
            return {}
        out = {f"p{round(q * 100):02d}": h.quantile(q) for q in qs}
        out["mean"] = h.sum / h.count
        out["count"] = float(h.count)
        return out

    # -- queue ---------------------------------------------------------------
    def _policy_for(self, req: SolveRequest) -> PrecisionPolicy:
        """The request's resolved precision policy (service default when
        the request doesn't name one)."""
        if req.precision is None:
            return self.precision
        return resolve_precision(req.precision)

    def group_key(self, req: SolveRequest) -> tuple:
        """Flight/solver-cache key: (p, refine, shape), the mesh's
        lengths, attribute layout and affine map, and (last) the
        resolved precision-policy name."""
        mesh = req.coarse_mesh if req.coarse_mesh is not None else beam_hex()
        lm = mesh.linear_map
        return (
            req.p,
            req.refine,
            mesh.shape,
            mesh.lengths,
            tuple(int(a) for a in mesh.attributes()),
            None if lm is None else tuple(map(tuple, np.asarray(lm).tolist())),
            self._policy_for(req).name,
        )

    def submit(self, request: SolveRequest) -> int:
        """Non-blocking intake: enqueue a request and return its ticket.

        Invalid requests fail HERE, before any batch state is touched:
        attribute dicts must cover every mesh attribute with positive
        coefficients, and ``(lam_e, mu_e)`` pairs must have shape
        (coarse_mesh.nelem * 8**refine,) with every entry positive."""
        if request.materials is not None:
            mesh = (
                request.coarse_mesh
                if request.coarse_mesh is not None
                else beam_hex()
            )
            m = request.materials
            if isinstance(m, dict):
                check_material_dict(
                    m, mesh.attributes(), where="request materials"
                )
            else:
                try:
                    lam_e, mu_e = m
                except (TypeError, ValueError):
                    raise TypeError(
                        f"request materials: expected an attribute->"
                        f"(lambda, mu) dict or a (lam_e, mu_e) array "
                        f"pair, got {type(m).__name__!r}"
                    ) from None
                nelem_fine = mesh.nelem * 8**request.refine
                check_material_fields(
                    lam_e,
                    mu_e,
                    nelem_fine,
                    where=(
                        f"request materials (p={request.p}, "
                        f"refine={request.refine}, coarse mesh "
                        f"{mesh.shape})"
                    ),
                )
        self._policy_for(request)  # unknown precision names fail at intake
        ticket = self._next_ticket
        self._next_ticket += 1
        self._t_submit[ticket] = self.clock()
        self._queue.append((ticket, request))
        return ticket

    def bucket_for(self, n: int) -> int:
        """Smallest padding bucket (1/2/4/.../max_batch) holding n rows."""
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        b = min(b, self.max_batch)
        m = self.n_shards
        return -(-b // m) * m

    # -- cache ---------------------------------------------------------------
    def _solver_for(self, key: tuple, req: SolveRequest):
        """(solver, cache_hit, t_setup) for a discretization key."""
        if key in self._solvers:
            self._solvers.move_to_end(key)
            self._inc("cache_hits", key)
            return self._solvers[key], True, 0.0
        t0 = self.clock()
        cmesh = req.coarse_mesh if req.coarse_mesh is not None else beam_hex()
        solver = BatchedGMGSolver(
            cmesh,
            req.refine,
            req.p,
            assembly=self.assembly,
            precision=self._policy_for(req),
            maxiter=self.maxiter,
            device=self.device,
            mesh=self.mesh,
        )
        self._solvers[key] = solver
        self._inc("cache_misses", key)
        while len(self._solvers) > self.cache_size:
            evicted, _ = self._solvers.popitem(last=False)  # LRU eviction
            if evicted in self._flights:
                # Never evict a solver with rows in flight: reinsert it as
                # least-recently-used and drop the next-oldest idle entry.
                self._solvers[evicted] = self._flights[evicted].solver
                self._solvers.move_to_end(evicted, last=False)
                for k in list(self._solvers):
                    if k not in self._flights:
                        del self._solvers[k]
                        break
        return solver, False, self.clock() - t0

    # -- continuous batching -------------------------------------------------
    def step(self) -> int:
        """Advance the continuous engine by one bounded chunk per
        in-flight discretization key: retire rows that stopped, refill
        freed slots from the queue, admit new submissions, re-bucket,
        and dispatch one chunk whose length the chunk policy picks.
        Returns the number of requests completed by this step.

        With a watchdog attached (:meth:`attach_watchdog`) the step runs
        under its monitor: a step past the timeout fires the counter and
        a span without interrupting the step (detection, not
        preemption)."""
        if self.watchdog is not None:
            with self.watchdog.step():
                return self._step_body()
        return self._step_body()

    def _step_body(self) -> int:
        self._step_index += 1
        rec = self.spans
        t_step0 = self.clock() if rec is not None else 0.0
        done_before = len(self._completed)
        qgroups: OrderedDict[tuple, list[tuple[int, SolveRequest]]] = (
            OrderedDict()
        )
        for t, req in self._queue:
            qgroups.setdefault(self.group_key(req), []).append((t, req))
        keys = list(self._flights)
        keys += [k for k in qgroups if k not in self._flights]
        admitted: set[int] = set()
        for key in keys:
            flight = self._flights.get(key)
            queued = qgroups.get(key, [])
            if flight is None:
                solver, hit, t_setup = self._solver_for(key, queued[0][1])
                flight = _Flight(
                    key, solver, hit, t_setup, tid_base=self._flight_tid()
                )
                self._flights[key] = flight
                if rec is not None:
                    rec.thread_name(
                        flight.tid_base,
                        f"flight p={key[0]} refine={key[1]}",
                    )
            self._retire(flight)
            if not flight.live_rows() and not queued:
                del self._flights[key]
                continue
            admitted |= self._admit(flight, queued)
            if flight.live_rows():
                self._launch_chunk(flight)
            else:
                del self._flights[key]
        if admitted:
            self._queue = [
                (t, r) for t, r in self._queue if t not in admitted
            ]
        completed = len(self._completed) - done_before
        if rec is not None:
            rec.emit(
                "step",
                cat="engine",
                tid=0,
                start=t_step0,
                end=self.clock(),
                step=self._step_index,
                completed=completed,
            )
        return completed

    def _flight_tid(self) -> int:
        """Next flight's Chrome-trace track block: tid 0 is the engine;
        each flight takes the flight track plus one tid per possible
        slot."""
        idx = self._next_flight_idx
        self._next_flight_idx += 1
        return 1 + idx * (self.max_batch + self.n_shards + 1)

    def idle(self) -> bool:
        """True when no requests are queued or in flight."""
        return not self._queue and not self._flights

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Drive ``step`` until every submitted request has completed."""
        steps = 0
        while not self.idle():
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"continuous engine did not drain in {max_steps} steps"
                )

    def drain(self) -> list[SolveReport]:
        """Non-blocking: pop every completed report (submission order);
        a report is never yielded twice, and padding rows never appear."""
        return [self._completed.pop(t) for t in sorted(self._completed)]

    def solve_continuous(
        self, requests: list[SolveRequest]
    ) -> list[SolveReport]:
        """Submit ``requests``, run the continuous engine until idle, and
        return their reports in submission order (other tickets, if any,
        stay drainable)."""
        tickets = [self.submit(r) for r in requests]
        self.run_until_idle()
        return [self._completed.pop(t) for t in tickets]

    def _finalize_chunk(self, flight: _Flight, consumed: np.ndarray | None) -> None:
        """Fold the last chunk's consumed vector into the host-side
        scheduling state: advance the per-row iteration mirror and patch
        the awaiting trace record (consumed, wasted slot-iterations)."""
        flight.pending_consumed = None
        if consumed is None:
            return
        flight.row_iters += consumed.astype(np.int64)
        d = flight.last_decision
        flight.last_decision = None
        if d is not None:
            d.consumed = tuple(int(c) for c in consumed)
            d.wasted = wasted_iterations(consumed, d.live_slots)
            self._inc("wasted_iters", flight.key, d.wasted)

    def _retire(self, flight: _Flight) -> None:
        """Emit reports for rows that stopped iterating (converged or hit
        maxiter) during the previous chunk and free their slots,
        recording each real row's retire cadence in the flight's history
        ring buffer (the adaptive policies' signal)."""
        if flight.state is None:
            return
        # The six (S,) convergence vectors and the last chunk's consumed
        # vector come back together: one transfer per retire pass.
        st = flight.state
        vecs = [st.active, st.nom, st.nom0, st.threshold, st.iters, st.stalled]
        pending = flight.pending_consumed is not None
        if pending:
            vecs.append(flight.pending_consumed)
        host = _to_host(vecs)
        self._finalize_chunk(flight, host[6] if pending else None)
        if flight.chunks == 0:
            return
        active, nom, nom0, thr, iters, stalled = host[:6]
        reduced = resolve_precision(flight.key[-1]).reduced
        live = flight.live_rows()
        ndof = flight.solver.fine_space.ndof
        now = self.clock()
        rec = self.spans
        for i in live:
            if active[i]:
                continue
            slot = flight.slots[i]
            req = slot.request
            converged = bool(nom[i] <= thr[i])
            if reduced and bool(stalled[i]) and not converged:
                # Stagnated under the reduced policy (or failed the true-
                # residual audit): re-queue the SAME ticket onto the f64
                # path with its original submit time.
                self._queue.append(
                    (slot.ticket,
                     dataclasses.replace(req, precision="f64"))
                )
                self._t_submit[slot.ticket] = slot.t_submit
                self._fallback_tickets.add(slot.ticket)
                self._inc("precision_fallbacks", flight.key)
                flight.slots[i] = None
                continue
            rel = (
                float(np.sqrt(nom[i]) / np.sqrt(nom0[i]))
                if nom0[i] > 0
                else 0.0
            )
            wall = now - slot.t_admit
            self._observe(
                "request_latency_seconds",
                "Admission-to-retirement latency per request.",
                flight.key,
                wall,
            )
            if rec is not None:
                # Lifecycle identity per ticket: queue_wait + compute +
                # overhead == submit-to-retire wall.
                rec.emit(
                    "solve",
                    cat="request",
                    tid=flight.tid_base + 1 + i,
                    start=slot.t_admit,
                    end=now,
                    ticket=slot.ticket,
                    iterations=int(iters[i]),
                    converged=converged,
                    queue_wait=slot.t_admit - slot.t_submit,
                    compute=slot.t_compute,
                    overhead=wall - slot.t_compute,
                    padding_overhead=slot.t_padding,
                )
            fell_back = slot.ticket in self._fallback_tickets
            self._fallback_tickets.discard(slot.ticket)
            self._completed[slot.ticket] = SolveReport(
                request=req,
                key=flight.key,
                iterations=int(iters[i]),
                converged=converged,
                final_rel_norm=rel,
                ndof=ndof,
                batch_size=len(live),
                generation=flight.chunks - 1,
                cache_hit=flight.cache_hit,
                t_setup=flight.t_setup,
                t_solve=now - slot.t_admit,
                born_converged=bool(
                    iters[i] == 0 and converged and nom0[i] == 0
                ),
                padded_rows=flight.bucket,
                precision=flight.key[-1],
                fallback=fell_back,
                ticket=slot.ticket,
                x=flight.state.x[i].cpu().numpy() if req.keep_solution else None,
            )
            flight.slots[i] = None
            # Retire cadence for the policies; born-converged rows (0
            # iterations) teach nothing about cadence and are skipped.
            if iters[i] > 0:
                flight.retire_history.append(int(iters[i]))

    def _admit(
        self, flight: _Flight, queued: list[tuple[int, SolveRequest]]
    ) -> set[int]:
        """Refill free slots from the queue, re-bucketing the state to
        the smallest sufficient batch size first.  Returns the admitted
        tickets; leaves ``flight.pending_reset`` marking every row the
        next chunk must (re)initialize."""
        solver = flight.solver
        live = flight.live_rows()
        n_live = len(live)
        take = queued[: self.max_batch - n_live]
        bucket = self.bucket_for(max(n_live + len(take), 1))

        if flight.state is None:
            flight.state = solver.empty_state(bucket)
            flight.prep = solver.empty_prep(bucket)
            flight.slots = [None] * bucket
            ne = solver.fine_space.nelem
            flight.lam = np.zeros((bucket, ne))
            flight.mu = np.zeros((bucket, ne))
            flight.mat_digest = np.zeros((bucket,), dtype=object)
            flight.tr = np.zeros((bucket, 3))
            flight.tol = np.full((bucket,), 1e-6)
            flight.prep_valid = np.zeros((bucket,), dtype=bool)
            flight.prep_digest = np.zeros((bucket,), dtype=object)
            flight.prep_lam = np.zeros((bucket, ne))
            flight.prep_mu = np.zeros((bucket, ne))
            flight.row_iters = np.zeros((bucket,), dtype=np.int64)
            flight.bucket = bucket
            reset = np.ones((bucket,), dtype=bool)
        elif bucket != flight.bucket:
            # Re-bucket: keep live rows (bitwise), fill the rest with
            # placeholder copies of an existing row — every placeholder
            # is reset below before the next chunk reads it.
            filler = live[0] if live else 0
            rows = live + [filler] * (bucket - n_live)
            flight.state, flight.prep = solver.take_rows(
                flight.state, flight.prep, rows
            )
            flight.slots = [flight.slots[i] for i in live] + [None] * (
                bucket - n_live
            )
            idx = np.asarray(rows)
            flight.lam = flight.lam[idx]
            flight.mu = flight.mu[idx]
            flight.mat_digest = flight.mat_digest[idx]
            flight.tr = flight.tr[idx]
            flight.tol = flight.tol[idx]
            flight.prep_valid = flight.prep_valid[idx]
            flight.prep_digest = flight.prep_digest[idx]
            flight.prep_lam = flight.prep_lam[idx]
            flight.prep_mu = flight.prep_mu[idx]
            flight.row_iters = flight.row_iters[idx]
            flight.bucket = bucket
            reset = np.zeros((bucket,), dtype=bool)
            reset[n_live:] = True
            self._inc("rebuckets", flight.key)
        else:
            reset = np.zeros((bucket,), dtype=bool)
        if (
            flight.pending_reset is not None
            and len(flight.pending_reset) == bucket
        ):
            reset |= flight.pending_reset

        admitted: set[int] = set()
        free = [i for i, s in enumerate(flight.slots) if s is None]
        # Refill placement is a policy decision; it never changes
        # numerics (rows are slot-independent).
        slot_devs = scenario_row_devices(flight.bucket, self.n_shards)
        order = self.chunk_policy.placement(
            free,
            [int(d) for d in slot_devs],
            [int(slot_devs[i]) for i in flight.live_rows()],
        )
        refills: list[RefillPlacement] = []
        now = self.clock()
        rec = self.spans
        for (ticket, req), row in zip(take, order):
            if flight.slots[row] is not None:  # pragma: no cover
                raise AssertionError(f"slot {row} double-assigned")
            t_submit = self._t_submit.pop(ticket, now)
            flight.slots[row] = _Slot(ticket, req, now, t_submit=t_submit)
            self._observe(
                "request_queue_wait_seconds",
                "Submit-to-admission wait per request.",
                flight.key,
                now - t_submit,
            )
            if rec is not None:
                tid = flight.tid_base + 1 + row
                rec.thread_name(tid, f"p={flight.key[0]} slot {row}")
                rec.emit(
                    "queue_wait",
                    cat="request",
                    tid=tid,
                    start=t_submit,
                    end=now,
                    ticket=ticket,
                )
            # The folded fields in the solver's dtype, back on the host in
            # one transfer (the digest and the prep match read them).
            lam, mu = solver.pack_materials([_req_materials(req)])
            flight.lam[row], flight.mu[row] = torch.cat([lam, mu]).cpu().numpy()
            flight.mat_digest[row] = _material_digest(
                flight.lam[row], flight.mu[row], precision=flight.key[-1]
            )
            flight.tr[row] = req.traction
            flight.tol[row] = req.rel_tol
            reset[row] = True
            admitted.add(ticket)
            refills.append(
                RefillPlacement(
                    ticket=ticket, slot=row, device=int(slot_devs[row])
                )
            )
            self._inc("refills", flight.key)
        # Padding rows being reset borrow a real row's materials (keeps
        # the batched operators SPD) with a zero traction: b == 0 makes
        # them born converged, so they cost 0 iterations and are never
        # surfaced to callers.
        occupied = flight.live_rows()
        if occupied:
            src = occupied[0]
            for row in range(flight.bucket):
                if flight.slots[row] is None and reset[row]:
                    flight.lam[row] = flight.lam[src]
                    flight.mu[row] = flight.mu[src]
                    flight.mat_digest[row] = flight.mat_digest[src]
                    flight.tr[row] = 0.0
                    flight.tol[row] = 1e-6
        flight.pending_reset = reset if reset.any() else None
        flight.pending_refills = tuple(refills)
        return admitted

    def _refresh_prep(self, flight: _Flight, reset: np.ndarray) -> None:
        """Make every reset row's prep match its (new) materials.  Rows
        whose folded fields content-match an already-valid row (digest
        first, confirmed bitwise against the snapshot) copy that row's
        derived data on the device; only new material configurations pay
        ``prepare`` (power iterations and refactorization)."""
        solver = flight.solver
        rec = self.spans
        t_prep0 = self.clock() if rec is not None else 0.0
        src_rows, dst_rows, unresolved = [], [], []
        sources = [s for s in range(flight.bucket) if flight.prep_valid[s]]
        for r in np.flatnonzero(reset):
            dig = flight.mat_digest[r]
            match = next(
                (
                    s
                    for s in sources
                    if flight.prep_digest[s] == dig
                    and np.array_equal(flight.prep_lam[s], flight.lam[r])
                    and np.array_equal(flight.prep_mu[s], flight.mu[r])
                ),
                None,
            )
            if match is None:
                unresolved.append(int(r))
            else:
                src_rows.append(match)
                dst_rows.append(int(r))
        if dst_rows:
            flight.prep = solver.copy_prep_rows(
                flight.prep, src_rows, dst_rows
            )
            self._inc("prep_row_copies", flight.key, len(dst_rows))
        if unresolved:
            mask = np.zeros((flight.bucket,), dtype=bool)
            mask[unresolved] = True
            flight.prep = solver.prepare(flight.lam, flight.mu, mask, flight.prep)
            self._inc("prep_calls", flight.key)
        flight.prep_valid[reset] = True
        flight.prep_digest[reset] = flight.mat_digest[reset]
        flight.prep_lam[reset] = flight.lam[reset]
        flight.prep_mu[reset] = flight.mu[reset]
        if rec is not None:
            rec.emit(
                "prep",
                cat="flight",
                tid=flight.tid_base,
                start=t_prep0,
                end=self.clock(),
                rows_reset=int(reset.sum()),
                rows_copied=len(dst_rows),
                rows_prepared=len(unresolved),
            )

    def _launch_chunk(self, flight: _Flight) -> None:
        """One bounded advance of the flight's state, re-initializing any
        rows flagged by the last admit.  The chunk length comes from the
        policy's view of the in-flight mix (the host-side iteration
        mirror, the per-device row map and the retire-history ring
        buffer); the decision is appended to ``self.trace`` and completed
        by the next retire pass."""
        solver = flight.solver
        reset = flight.pending_reset
        do_reset = reset is not None
        if do_reset:
            self._refresh_prep(flight, reset)
            flight.row_iters[reset] = 0
        mask = (
            reset if do_reset else np.zeros((flight.bucket,), dtype=bool)
        )
        live = flight.live_rows()
        slot_devs = scenario_row_devices(flight.bucket, self.n_shards)
        obs = ChunkObservation(
            live_iters=tuple(int(flight.row_iters[i]) for i in live),
            live_devices=tuple(int(slot_devs[i]) for i in live),
            history=tuple(flight.retire_history),
            bucket=flight.bucket,
            n_devices=self.n_shards,
        )
        k = self.chunk_policy.chunk_for(obs)
        rec = self.spans
        t0 = self.clock() if rec is not None else 0.0
        flight.state, flight.pending_consumed = solver.run_chunk(
            flight.tr,
            flight.tol,
            mask,
            flight.state,
            flight.prep,
            k,
            do_reset=do_reset,
        )
        if rec is not None:
            t_dispatched = self.clock()
            rec.emit(
                "chunk_dispatch",
                cat="chunk",
                tid=flight.tid_base,
                start=t0,
                end=t_dispatched,
                chunk=k,
                bucket=flight.bucket,
                live=len(live),
            )
            if rec.fence:
                # Fence, don't fetch: wait for the chunk's work without
                # transferring anything; the consumed vector still comes
                # back with the next retire pass.
                synchronize(self._devices)
                t_done = self.clock()
                dt_dev = t_done - t_dispatched
                rec.emit(
                    "chunk_device",
                    cat="chunk",
                    tid=flight.tid_base,
                    start=t_dispatched,
                    end=t_done,
                    chunk=k,
                    bucket=flight.bucket,
                    live=len(live),
                )
                self._observe(
                    "chunk_device_seconds",
                    "Device-fenced wall time per continuous chunk.",
                    flight.key,
                    dt_dev,
                )
                # Each live ticket accrues the full chunk time as compute,
                # plus its share of the padding fraction as padding
                # overhead.
                n_live = len(live)
                pad_share = (
                    dt_dev * (flight.bucket - n_live) / flight.bucket / n_live
                    if n_live
                    else 0.0
                )
                for i in live:
                    flight.slots[i].t_compute += dt_dev
                    flight.slots[i].t_padding += pad_share
        decision = ChunkDecision(
            step=self._step_index,
            key=flight.key,
            policy=self.chunk_policy.name,
            bucket=flight.bucket,
            observation=obs,
            chunk=k,
            refills=flight.pending_refills,
            live_slots=tuple(live),
        )
        self.trace.append(decision)
        flight.last_decision = decision
        flight.pending_refills = ()
        flight.pending_reset = None
        flight.chunks += 1
        self._inc("chunks", flight.key)
        self._inc("chunk_iters_dispatched", flight.key, k)

    # -- generational batching -----------------------------------------------
    def solve(self, requests: list[SolveRequest] | None = None) -> list[SolveReport]:
        """Generational path: drain the queue (plus ``requests``) and
        return one report per request, in submission order.

        Each discretization key's requests are solved in batches of up to
        ``max_batch``, padded to the smallest sufficient bucket; padding
        rows are never surfaced.  Do not mix with in-flight continuous
        work — use ``solve_continuous`` there."""
        if requests:
            for r in requests:
                self.submit(r)
        pending = [r for _, r in self._queue]
        for t, _ in self._queue:
            self._t_submit.pop(t, None)
        self._queue = []

        groups: OrderedDict[tuple, list[tuple[int, SolveRequest]]] = OrderedDict()
        for i, req in enumerate(pending):
            groups.setdefault(self.group_key(req), []).append((i, req))

        reports: list[SolveReport | None] = [None] * len(pending)
        for key, members in groups.items():
            solver, hit, t_setup = self._solver_for(key, members[0][1])
            for gen, start in enumerate(range(0, len(members), self.max_batch)):
                chunk = members[start : start + self.max_batch]
                gen_reports = self._run_generation(
                    solver, key, chunk, hit or gen > 0, t_setup if gen == 0 else 0.0, gen
                )
                for (i, _), rep in zip(chunk, gen_reports):
                    reports[i] = rep
        return reports  # type: ignore[return-value]

    def _run_generation(
        self,
        solver: BatchedGMGSolver,
        key: tuple,
        chunk: list[tuple[int, SolveRequest]],
        cache_hit: bool,
        t_setup: float,
        generation: int,
    ) -> list[SolveReport]:
        reqs = [r for _, r in chunk]
        n_real = len(reqs)
        n_pad = self.bucket_for(n_real) - n_real
        materials, tractions, rel_tols, _ = solver.pad_scenarios(
            [_req_materials(r) for r in reqs],
            [r.traction for r in reqs],
            [r.rel_tol for r in reqs],
            n=n_real + n_pad,
        )

        synchronize(self._devices)
        t0 = self.clock()
        res = solver.solve(materials, tractions, rel_tols)
        synchronize(self._devices)
        t_solve = self.clock() - t0
        self._inc("generations", key)
        for _ in reqs:
            self._observe(
                "request_latency_seconds",
                "Admission-to-retirement latency per request.",
                key,
                t_solve,
            )
        if self.spans is not None:
            self.spans.emit(
                "generation",
                cat="generation",
                tid=0,
                start=t0,
                end=t0 + t_solve,
                generation=generation,
                batch=n_real,
                padded_rows=n_real + n_pad,
            )

        iters, conv, fin, ini, fell_back = _to_host([
            res.iterations, res.converged, res.final_norm, res.initial_norm,
            res.fallback,
        ])
        ndof = solver.fine_space.ndof
        out = []
        for s, req in enumerate(reqs):
            rel = float(fin[s] / ini[s]) if ini[s] > 0 else 0.0
            if fell_back[s]:
                self._inc("precision_fallbacks", key)
            out.append(
                SolveReport(
                    request=req,
                    key=key,
                    iterations=int(iters[s]),
                    converged=bool(conv[s]),
                    final_rel_norm=rel,
                    ndof=ndof,
                    batch_size=n_real,
                    generation=generation,
                    cache_hit=cache_hit,
                    t_setup=t_setup,
                    t_solve=t_solve,
                    born_converged=bool(iters[s] == 0 and conv[s] and ini[s] == 0),
                    padded_rows=n_real + n_pad,
                    precision=solver.precision.name,
                    fallback=bool(fell_back[s]),
                    x=res.x[s].cpu().numpy() if req.keep_solution else None,
                )
            )
        return out
