"""Continuous-batching CNN serving tier (port of ``repro/launch/server.py``).

The pipeline is admission -> queue -> bucketer -> frozen-plan dispatch:

- :class:`CNNServer` owns a thread-safe request queue. ``submit(x)`` (``x``:
  a numpy ``(n, H, W, C)``, any ``n >= 1``) returns a
  ``concurrent.futures.Future`` of that request's logits.
- A dispatcher thread aggregates requests with :class:`MicroBatcher`: it
  flushes as soon as ``max_batch`` samples are pending, or when the oldest
  pending request has waited ``max_wait_ms``.
- Each batch is assembled on the host and served through a
  :class:`~repro_torch.models.plan.PlanSet`: padded up to the nearest
  bucket, that bucket's graph replayed, the padding sliced off, each
  request's rows handed to its future. Every bucket is captured at warmup,
  so sustained variable load captures nothing new, a contract the server
  measures (:attr:`CNNServer.retraces_after_warmup`), and each request's
  logits equal serving it alone (rows are independent end to end). One
  batch is in flight at a time.

Robustness:

- **Admission**: ``max_queue`` bounds in-system samples; beyond it
  ``shed='reject'`` raises :class:`Overloaded` with a retry-after from the
  measured bucket time, and ``shed='block'`` holds the submitter. Every
  request is validated against the plan set's per-sample spec (shape,
  dtype, finite values): a malformed one fails alone with
  :class:`InvalidRequest`.
- **Deadlines**: ``submit(x, deadline_s=)``. The batcher flushes early
  enough to meet a deadline (less the measured service estimate), and a
  request already past its deadline fails with :class:`DeadlineExceeded`
  before it costs a dispatch.
- **Isolation**: a batch whose dispatch raises is bisected until the
  exception sits on the poison request alone; non-finite logits fail only
  their request (:class:`NumericalFault`).
- **Supervision**: a dispatcher crash fails every pending future with
  :class:`ServerCrashed`, or hands the undispatched ones to ``on_crash``
  to be requeued across a restart; :meth:`CNNServer.health` reports
  ready / degraded / stopped; :meth:`CNNServer.stop` drains within
  ``timeout_s``.
- **Degradation**: with ``fallback=`` (per-bucket closures from
  ``SparseCNN.fallback_plan_set``: the same kernels without graphs),
  ``demote_after`` consecutive failed dispatches of one bucket's plan
  demote that bucket to its fallback, and every ``probe_every``-th
  dispatch of a demoted bucket tries the plan again and promotes it back
  on success. :meth:`CNNServer.swap_plan_set` replaces
  the plan set between dispatches (the hot reload of
  :class:`~repro_torch.launch.supervisor.Supervisor`).
- **Faults**: ``faults=`` installs a deterministic injector
  (:class:`repro_torch.launch.faults.FaultInjector`) at five seams.

:class:`ServerStats` closes the books: ``completed + rejected + failed +
expired == submitted`` once the server has stopped. Every time the server
reads comes from ``clock`` (``time.monotonic`` unless a test injects one).
"""
from __future__ import annotations

import dataclasses
import logging
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.plan import shard_plan_set

log = logging.getLogger(__name__)


class ServeError(RuntimeError):
    """Base of every typed serving-tier failure."""


class InvalidRequest(ServeError, ValueError):
    """Rejected at admission: the request does not match the plan's
    per-sample spec (shape, dtype, finite values) or is malformed. It fails
    alone and never reaches a co-batch."""


class Overloaded(ServeError):
    """Shed at admission: the bounded queue is full (``shed='reject'``).
    ``retry_after_s`` estimates when capacity frees up, from the measured
    bucket time and the backlog."""

    def __init__(self, msg: str, *, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServeError):
    """The request's deadline passed while it was queued; it was failed
    before it cost a dispatch."""


class NumericalFault(ServeError):
    """This request's logits came back non-finite; its co-batched requests
    were not affected (rows are independent)."""


class ServerCrashed(ServeError):
    """The dispatcher thread died; pending futures fail with this instead of
    stranding their waiters."""


def poisson_arrivals(rate_rps: float, n: int, *, seed: int = 0) -> np.ndarray:
    """``n`` arrival offsets (seconds, ascending) of a Poisson process at
    ``rate_rps`` requests/s: exponential gaps, seeded."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def burst_arrivals(n: int, *, burst: int, gap_s: float, start: float = 0.0) -> np.ndarray:
    """``n`` arrival offsets in bursts of ``burst`` requests at one instant,
    ``gap_s`` apart: idle, then a queue-depth spike."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    return np.asarray([start + (i // burst) * gap_s for i in range(n)])


def validate_request(x, sample_spec: Tuple[Tuple[int, ...], str], *,
                     check_finite: bool = True) -> None:
    """Admission check of a request against a plan's per-sample spec
    ``(shape without the batch, dtype name)``: :class:`InvalidRequest` on a
    shape or dtype mismatch and, for floating inputs, on any non-finite
    value, so a NaN request fails alone."""
    shape, dtype = sample_spec
    if tuple(x.shape[1:]) != tuple(shape):
        raise InvalidRequest(f"request sample shape {tuple(x.shape[1:])} != plan spec "
                             f"{tuple(shape)}")
    if np.dtype(x.dtype) != np.dtype(dtype):
        raise InvalidRequest(f"request dtype {np.dtype(x.dtype).name} != plan spec {dtype}")
    if check_finite and np.issubdtype(np.dtype(dtype), np.floating):
        if not np.isfinite(np.asarray(x)).all():
            raise InvalidRequest("request contains non-finite values")


@dataclasses.dataclass
class _Pending:
    """One queued request: its samples, arrival time, future and (optional)
    absolute deadline."""

    x: np.ndarray
    n: int
    arrival: float
    future: Future
    deadline: Optional[float] = None


class MicroBatcher:
    """Aggregation logic with no threads and no clock of its own.

    Holds requests until ``max_batch`` samples wait (flush at once) or the
    oldest has waited ``max_wait_s`` (flush what is there). A request is
    never split: one that would overflow the batch flushes the batch first,
    and one larger than ``max_batch`` is a batch of its own (``PlanSet.serve``
    chunks it). A request's deadline, less the caller's service estimate,
    pulls the flush time earlier.
    """

    def __init__(self, max_batch: int, max_wait_s: float):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._pending: List[_Pending] = []
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def add(self, p: _Pending) -> List[List[_Pending]]:
        """Queue one request; return the batches (0, 1 or 2) it flushed."""
        out = []
        if self._pending and self._count + p.n > self.max_batch:
            out.append(self.take())
        self._pending.append(p)
        self._count += p.n
        if self._count >= self.max_batch:
            out.append(self.take())
        return out

    def deadline(self, service_est_s: float = 0.0) -> Optional[float]:
        """When the pending set must flush: the oldest arrival plus the
        max wait, or a request's deadline less ``service_est_s`` if
        earlier."""
        if not self._pending:
            return None
        dl = self._pending[0].arrival + self.max_wait_s
        for p in self._pending:
            if p.deadline is not None:
                dl = min(dl, p.deadline - service_est_s)
        return dl

    def due(self, now: float, service_est_s: float = 0.0) -> bool:
        dl = self.deadline(service_est_s)
        return dl is not None and now >= dl

    def take(self) -> List[_Pending]:
        """Flush everything pending."""
        batch, self._pending, self._count = self._pending, [], 0
        return batch


@dataclasses.dataclass
class ServerStats:
    """Counters of one serving run, in samples. Every offered sample ends in
    exactly one of ``completed`` (served), ``rejected`` (shed or invalid at
    admission), ``expired`` (deadline missed while queued) and ``failed``
    (a dispatch or output fault, a crash, or cancelled by a stop that did
    not drain): ``completed + rejected + failed + expired == submitted``
    once the server has stopped, across supervised restarts too.
    ``requeued`` counts samples handed back by a crash and queued again (not
    offered twice); ``restarts`` the supervised restarts, ``reloads`` the
    plan-set swaps, ``demotions`` and ``promotions`` the buckets moved to
    their fallback and back."""

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    expired: int = 0
    batches: int = 0
    served_samples: int = 0
    padded_samples: int = 0
    bucket_counts: dict = dataclasses.field(default_factory=dict)
    latencies_s: list = dataclasses.field(default_factory=list)
    first_arrival: Optional[float] = None
    last_done: Optional[float] = None
    warmup_traces: int = 0
    requeued: int = 0
    restarts: int = 0
    reloads: int = 0
    demotions: int = 0
    promotions: int = 0

    @property
    def accounted(self) -> int:
        return self.completed + self.rejected + self.failed + self.expired

    def accounting_ok(self) -> bool:
        return self.accounted == self.submitted

    def assert_accounting(self) -> None:
        if not self.accounting_ok():
            raise AssertionError(
                f"accounting identity violated: completed {self.completed} + rejected "
                f"{self.rejected} + failed {self.failed} + expired {self.expired} = "
                f"{self.accounted} != offered {self.submitted}")

    def summary(self) -> dict:
        """p50/p99/mean latency (µs) of completed requests, completed
        samples/s from the first arrival to the last completion, the shed
        rate, the terminal counters and the aggregation shape."""
        lat_us = np.asarray(self.latencies_s, dtype=np.float64) * 1e6
        span = ((self.last_done - self.first_arrival)
                if self.completed and self.last_done is not None else 0.0)
        return {
            "offered": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "expired": self.expired,
            "accounting_ok": self.accounting_ok(),
            "batches": self.batches,
            "p50_us": round(float(np.percentile(lat_us, 50)), 1) if len(lat_us) else None,
            "p99_us": round(float(np.percentile(lat_us, 99)), 1) if len(lat_us) else None,
            "mean_us": round(float(lat_us.mean()), 1) if len(lat_us) else None,
            "throughput_rps": round(self.completed / span, 2) if span > 0 else None,
            "shed_rate": round(self.rejected / self.submitted, 4) if self.submitted else 0.0,
            "bucket_counts": {str(k): v for k, v in sorted(self.bucket_counts.items())},
            "padded_frac": (round(self.padded_samples / self.served_samples, 4)
                            if self.served_samples else 0.0),
            "restarts": self.restarts,
            "requeued": self.requeued,
            "reloads": self.reloads,
            "demotions": self.demotions,
            "promotions": self.promotions,
        }


_STOP = object()


class CNNServer:
    """Continuous-batching front end over a frozen :class:`PlanSet`.

    >>> plan_set = model.plan_set(max_batch=64)
    >>> with CNNServer(plan_set, max_wait_ms=5.0, max_queue=256) as srv:
    ...     srv.warmup()                           # every bucket captured
    ...     fut = srv.submit(x1, deadline_s=0.2)   # x1: numpy (1, 64, 64, 3)
    ...     logits = fut.result(timeout=srv.request_timeout_s())
    >>> srv.stats.summary()["p99_us"], srv.retraces_after_warmup  # -> ..., 0

    ``max_queue`` bounds admitted in-system samples (None: unbounded);
    ``shed`` is the overload policy; ``validate`` checks each request
    against the plan's sample spec; ``check_outputs`` fails a request whose
    logits are not finite; ``faults`` installs an injector;
    ``on_crash(exc, pendings)``, when set, receives the admitted but
    undispatched requests of a crashed dispatcher (to :meth:`requeue` them
    after a restart) instead of their failing. The dispatcher serves each
    batch to completion before it resolves the futures, so a latency runs
    from arrival to logits on the host.

    ``fallback`` (``{bucket: serve}``, ``SparseCNN.fallback_plan_set``)
    turns on per-bucket demotion: ``demote_after`` consecutive failed
    dispatches of a bucket's plan move that bucket to its fallback (counted
    in ``stats.demotions``, logged, and reported by :meth:`health` as
    ``'degraded'`` with ``demoted: {bucket: reason}``); every
    ``probe_every``-th dispatch of a demoted bucket tries its plan again and
    promotes it on success (None: never). The fallback runs the same
    kernels without graphs, so demotion rescues only a failure of the
    bucket's graph path that raises on the host: a capture or a replay that
    fails, the injector's ``pre_bucket``. A shape a wrapper refuses, or a
    kernel that fails to build or load, fails the fallback too, and the
    request fails typed. A fault inside a kernel (an illegal address) is a
    sticky CUDA error that poisons the process's context, and no fallback
    on the same card can serve after it. No serving entry point builds a
    fallback; a caller opts in.

    ``mesh`` (a ``launch.mesh.LocalMesh`` of the devices this process
    drives) serves data-parallel under one controller: the one queue,
    batcher, clock, bisection and demotion above. Each coordinate of the
    data axes (``cnn_serve_rules(multi_pod=)``: 'data', or 'pod' and
    'data') holds a replica of the plan set on its device, bucket ``b``
    staged at ``b / dp`` rows with bucket ``b``'s launch choices
    (``plan.shard_plan_set``; build the set with ``plan_set(dp=)``); the
    'model' axis only replicates, so it runs once. Each padded bucket is
    split into ``dp`` slices, each launched on its replica, and the logits
    gathered in order: equal bit for bit to the unsharded plan's. A replica
    that raises raises from the bucket's dispatch, so the faults above
    behave as on one device; ``fallback`` closures serve the whole bucket
    on one device. ``swap_plan_set`` replicates and warms the new set.
    """

    def __init__(self, plan_set, *, max_batch: Optional[int] = None, max_wait_ms: float = 5.0,
                 mesh=None, multi_pod: bool = False, max_queue: Optional[int] = None,
                 shed: str = "reject", validate: bool = True, check_outputs: bool = True,
                 faults=None, fallback=None, demote_after: int = 2,
                 probe_every: Optional[int] = 4, on_crash=None,
                 clock: Callable[[], float] = time.monotonic):
        if shed not in ("reject", "block"):
            raise ValueError(f"shed must be 'reject' or 'block', got {shed!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if demote_after < 1:
            raise ValueError(f"demote_after must be >= 1, got {demote_after}")
        if probe_every is not None and probe_every < 2:
            raise ValueError(f"probe_every must be >= 2, got {probe_every}")
        self._devices = None
        if mesh is not None:
            from repro_torch.sharding.rules import cnn_serve_rules

            self._devices = mesh.along(cnn_serve_rules(multi_pod=multi_pod)["batch"])
            plan_set = shard_plan_set(plan_set, self._devices)
        self.plan_set = plan_set
        self.max_batch = int(max_batch or plan_set.buckets[-1])
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = max_queue
        self.shed = shed
        self.stats = ServerStats()
        self.on_crash = on_crash
        self._validate = validate
        self._check_outputs = check_outputs
        self._faults = faults
        self._clock = clock
        self._fallback = dict(fallback) if fallback is not None else None
        self._demote_after = int(demote_after)
        self._probe_every = probe_every
        self._strikes: dict = {}  # bucket -> consecutive failed plan dispatches
        self._demoted: dict = {}  # bucket -> {'reason', 'dispatches'}
        self._inflight: dict = {}  # id(p) -> p, dispatcher thread only
        # dispatcher thread only: requests taken off the queue and not yet
        # in the batcher, and batches the batcher let go of and not yet
        # dispatched; a crash hands both back with the batcher's
        self._held: deque = deque()
        self._ready: List[List[_Pending]] = []
        self._batcher = MicroBatcher(self.max_batch, self.max_wait_s)
        self._q: _queue.Queue = _queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)  # holds shed='block' submitters
        self._abandon = threading.Event()  # stop(timeout_s=) gave up draining
        self._closed = False
        self._crashed: Optional[BaseException] = None
        self._degraded = False  # the last dispatch hit a fault
        self._depth = 0  # admitted samples not yet resolved
        self._bucket_time_s: Optional[float] = None  # EMA of the serve time
        self._ran = False

    # ------------------------------------------------------- lifecycle
    def start(self, *, fresh_stats: bool = True) -> "CNNServer":
        """Start the dispatcher. A restart after :meth:`stop` keeps requests
        already requeued, and with ``fresh_stats`` (the default) opens new
        books and re-baselines the capture count (the buckets stay
        captured); ``fresh_stats=False`` keeps the books open across a
        supervised restart."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self._ran:
            keep: List[_Pending] = []
            while True:  # drop stale stop sentinels, keep requeued requests
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if isinstance(item, _Pending):
                    keep.append(item)
            for p in keep:
                self._q.put(p)
            if fresh_stats:
                self.stats = ServerStats()
                self.stats.warmup_traces = self.plan_set.trace_count
            self._batcher = MicroBatcher(self.max_batch, self.max_wait_s)
            with self._lock:
                self._crashed = None
                self._degraded = False
                self._depth = sum(p.n for p in keep)
        self._ran = True
        self._abandon.clear()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="cnn-serve-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout_s: Optional[float] = None) -> None:
        """Stop the dispatcher. ``drain=True`` serves what is still queued
        first, so every submitted future resolves; past ``timeout_s`` the
        rest is cancelled (waiters get ``CancelledError``, never a hang)."""
        if self._thread is None:
            return
        with self._lock:
            self._closed = True  # submits racing the sentinel are refused
            self._q.put((_STOP, drain))
            self._space.notify_all()  # blocked submitters fail fast
        self._thread.join(timeout_s)
        if self._thread.is_alive():
            self._abandon.set()  # the drain cancels the rest and exits
            self._thread.join()
        self._thread = None

    def __enter__(self) -> "CNNServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------- hot path
    def warmup(self, sample_shape: Optional[Sequence[int]] = None, dtype="float32") -> int:
        """Capture every bucket, seed the service estimate with one timed
        largest-bucket dispatch, and snapshot the capture count: the
        baseline of :attr:`retraces_after_warmup`. ``sample_shape``
        defaults to the plan set's sample spec."""
        if sample_shape is None and self.plan_set.sample_spec is not None:
            sample_shape, dtype = self.plan_set.sample_spec
        self.plan_set.warmup(tuple(sample_shape), dtype)
        xb = np.zeros((self.plan_set.buckets[-1],) + tuple(sample_shape), dtype)
        t0 = self._clock()
        self.plan_set.serve(xb)  # warm: captures nothing
        self._note_service_time(self._clock() - t0)
        self.stats.warmup_traces = self.plan_set.trace_count
        return self.stats.warmup_traces

    @property
    def retraces_after_warmup(self) -> int:
        return self.plan_set.trace_count - self.stats.warmup_traces

    def submit(self, x, *, deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request (``x``: numpy ``(n, ...)``, ``n >= 1``);
        returns the future of its ``(n, num_classes)`` numpy logits.
        ``deadline_s`` (relative) bounds its time in the system: still
        queued past it, it fails with :class:`DeadlineExceeded` before any
        dispatch. Raises :class:`InvalidRequest` on a failed validation and
        :class:`Overloaded` when the bounded queue sheds; both count."""
        x = np.asarray(x)
        if x.ndim < 2 or x.shape[0] < 1:
            raise InvalidRequest(f"request must be (n, ...) with n >= 1: {x.shape}")
        n = int(x.shape[0])
        now = self._clock()
        with self._lock:
            if self._crashed is not None:
                raise ServerCrashed(f"server crashed: {self._crashed!r} (restart with start())")
            if self._thread is None or self._closed:
                raise RuntimeError("server is not running (use `with CNNServer(...)`)")
            self.stats.submitted += n  # offered, whatever happens next
            if self.stats.first_arrival is None:
                self.stats.first_arrival = now
        try:
            if deadline_s is not None and deadline_s <= 0:
                raise InvalidRequest(f"deadline_s must be > 0: {deadline_s}")
            if self._validate and self.plan_set.sample_spec is not None:
                validate_request(x, self.plan_set.sample_spec)
        except InvalidRequest:
            with self._lock:
                self.stats.rejected += n
            raise
        fut: Future = Future()
        p = _Pending(x=x, n=n, arrival=now, future=fut,
                     deadline=None if deadline_s is None else now + deadline_s)
        with self._lock:
            if self.max_queue is not None and self._depth + n > self.max_queue:
                if self.shed == "reject":
                    self.stats.rejected += n
                    raise Overloaded(f"queue full ({self._depth}/{self.max_queue} samples)",
                                     retry_after_s=self._retry_after_locked())
                while (self._depth + n > self.max_queue and not self._closed
                       and self._crashed is None):
                    self._space.wait()
                if self._closed or self._crashed is not None:
                    self.stats.rejected += n
                    raise RuntimeError("server stopped while backpressured")
            self._depth += n
            self._q.put(p)  # under the lock: nothing can trail a crash drain
        return fut

    def serve_batch(self, x):
        """Synchronous bucketed serve, no queue (pad, bucket plan, slice):
        the dispatcher's path, open to direct callers, demotion routing
        included. The plan set and its fallback are read once per batch."""
        with self._lock:
            ps, fallback = self.plan_set, self._fallback
        return ps.serve(x, on_dispatch=self._record,
                        dispatch=lambda b, xb: self._bucket_dispatch(ps, fallback, b, xb))

    def requeue(self, pendings: List[_Pending]) -> int:
        """Queue again the requests a crash handed to ``on_crash``: on a
        stopped server before :meth:`start`, or on a running one. They are
        not offered again (``requeued`` keeps the books). Returns the
        samples requeued."""
        total = 0
        with self._lock:
            if self._thread is not None and (self._closed or self._crashed is not None):
                raise RuntimeError("cannot requeue into a crashed or closing server "
                                   "(reap the dispatcher with stop() first)")
            for p in pendings:
                self.stats.requeued += p.n
                self._depth += p.n
                total += p.n
                self._q.put(p)
        return total

    def fail_pending(self, pendings: List[_Pending], exc: Exception) -> None:
        """Fail requests a crash handed back; each sample lands in ``failed``."""
        for p in pendings:
            self._fail(p, exc, kind="failed")

    def cancel_pending(self, pendings: List[_Pending]) -> None:
        """Cancel requests a crash handed back (waiters get ``CancelledError``)."""
        for p in pendings:
            self._cancel(p)

    def swap_plan_set(self, new_set, *, fallback=None) -> None:
        """Replace the serving :class:`PlanSet` (the hot reload). The
        dispatcher reads the set once per batch, so the swap lands between
        batches: one in flight finishes on the old set, every later one runs
        the new. The caller passes a set already warm (``Supervisor.reload``
        warms it off the dispatcher thread); the capture count's baseline
        moves to the new set, so :attr:`retraces_after_warmup` carries on.
        The fallback closures and the demotion state belong to the old
        weights and are replaced. Refuses another bucket ladder or sample
        spec."""
        if self._devices is not None:  # replicas of the new weights, warmed here
            new_set = shard_plan_set(new_set, self._devices)
            if new_set.sample_spec is not None:
                new_set.warmup()
        if tuple(new_set.buckets) != tuple(self.plan_set.buckets):
            raise ValueError(f"swap buckets {new_set.buckets} != serving ladder "
                             f"{self.plan_set.buckets}")
        if (self.plan_set.sample_spec is not None
                and new_set.sample_spec != self.plan_set.sample_spec):
            raise ValueError(f"swap sample spec {new_set.sample_spec} != admission contract "
                             f"{self.plan_set.sample_spec}")
        with self._lock:
            self.plan_set = new_set
            self.stats.warmup_traces = new_set.trace_count
            self.stats.reloads += 1
            self._fallback = dict(fallback) if fallback is not None else None
            self._strikes.clear()
            self._demoted.clear()

    # ------------------------------------------------------- degradation
    def _bucket_dispatch(self, ps, fallback, b: int, xb):
        """One bucket's dispatch: its plan while healthy; its fallback once
        demoted, except every ``probe_every``-th dispatch, which tries the
        plan and promotes the bucket when it succeeds."""
        with self._lock:
            dem = self._demoted.get(b)
            probe = False
            if dem is not None:
                dem["dispatches"] += 1
                probe = (self._probe_every is not None
                         and dem["dispatches"] % self._probe_every == 0)
        if dem is not None and not probe:
            return fallback[b](xb)
        try:
            if self._faults is not None:
                self._faults.pre_bucket(b)  # the backend-fault seam
            y = ps.plans[b].serve(xb)
        except Exception as e:  # noqa: BLE001 -- strike, demote, or pass it on
            if dem is not None:  # a failed probe: stay demoted
                return fallback[b](xb)
            if self._strike(b, e, fallback):
                return fallback[b](xb)  # demoted now: the batch is rescued
            raise  # below the threshold: bisection isolates the batch
        if dem is not None:
            self._promote(b)
        else:
            with self._lock:
                self._strikes.pop(b, None)  # a clean dispatch clears the strikes
        return y

    def _strike(self, b: int, exc: Exception, fallback) -> bool:
        """One failed plan dispatch of bucket ``b``; True when it demoted."""
        with self._lock:
            if b in self._demoted:
                return False
            k = self._strikes.get(b, 0) + 1
            self._strikes[b] = k
            if fallback is None or b not in fallback or k < self._demote_after:
                return False
            reason = f"{type(exc).__name__}: {exc}"
            self._demoted[b] = {"reason": reason, "dispatches": 0}
            self._strikes.pop(b, None)
            self.stats.demotions += 1
        log.warning("bucket %d demoted to its fallback after %d failed dispatches: %s",
                    b, k, reason)
        return True

    def _promote(self, b: int) -> None:
        with self._lock:
            if self._demoted.pop(b, None) is None:
                return
            self._strikes.pop(b, None)
            self.stats.promotions += 1
        log.warning("bucket %d promoted back to its plan", b)

    def demoted_buckets(self) -> dict:
        """``{bucket: reason}`` of the buckets serving on their fallback."""
        with self._lock:
            return {b: d["reason"] for b, d in sorted(self._demoted.items())}

    # ---------------------------------------------------------- health
    def health(self) -> dict:
        """``status``: ``'ready'`` (dispatching, the last dispatch clean, the
        queue below its bound), ``'degraded'`` (running, but the last
        dispatch hit a fault, the queue is at its bound or a bucket is
        demoted; ``demoted`` is ``{bucket: reason}``) or ``'stopped'`` (not
        started, stopped or crashed; ``crashed`` tells)."""
        with self._lock:
            running = self._thread is not None and not self._closed and self._crashed is None
            at_capacity = self.max_queue is not None and self._depth >= self.max_queue
            demoted = {b: d["reason"] for b, d in sorted(self._demoted.items())}
            if not running:
                status = "stopped"
            elif self._degraded or at_capacity or demoted:
                status = "degraded"
            else:
                status = "ready"
            return {"status": status, "crashed": self._crashed is not None,
                    "queue_depth": self._depth, "max_queue": self.max_queue,
                    "service_estimate_s": self._bucket_time_s, "demoted": demoted}

    def service_estimate_s(self) -> Optional[float]:
        """EMA of the measured batch serve time (seeded by warmup)."""
        with self._lock:
            return self._bucket_time_s

    def request_timeout_s(self, *, slack_buckets: float = 8.0, floor_s: float = 5.0) -> float:
        """A client's ``Future.result`` timeout from the server's own
        configuration: the worst backlog ahead (``max_queue`` when bounded,
        else the current depth) in buckets plus ``slack_buckets``, at the
        measured bucket time, plus the max wait; at least ``floor_s``."""
        with self._lock:
            bt = self._bucket_time_s
            depth = self.max_queue if self.max_queue is not None else self._depth
        bt = bt if bt is not None else 1.0
        buckets = -(-max(depth, 0) // self.max_batch) + slack_buckets
        return max(floor_s, self.max_wait_s + buckets * bt)

    # ------------------------------------------------------- internals
    def _retry_after_locked(self) -> float:
        bt = self._bucket_time_s or self.max_wait_s
        return self.max_wait_s + max(1, -(-self._depth // self.max_batch)) * bt

    def _note_service_time(self, dt: float) -> None:
        with self._lock:
            bt = self._bucket_time_s
            self._bucket_time_s = dt if bt is None else 0.8 * bt + 0.2 * dt

    def _record(self, bucket: int, n_real: int) -> None:
        self.stats.batches += 1
        self.stats.served_samples += bucket
        self.stats.padded_samples += bucket - n_real
        self.stats.bucket_counts[bucket] = self.stats.bucket_counts.get(bucket, 0) + 1

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 -- supervised: fail the futures
            self._crash(e)

    def _loop_inner(self) -> None:
        stop = None
        while stop is None:
            est = self._bucket_time_s or 0.0
            dl = self._batcher.deadline(est)
            timeout = None if dl is None else max(0.0, dl - self._clock())
            try:
                items = [self._q.get(timeout=timeout)]
            except _queue.Empty:
                items = []  # the max wait expired with nothing new queued
            while True:  # a backlog coalesces into full buckets
                try:
                    items.append(self._q.get_nowait())
                except _queue.Empty:
                    break
            if self._faults is not None and items:
                try:
                    self._faults.on_tick(len(items))  # the dispatcher-kill seam
                except BaseException:
                    for it in items:  # keep them for _crash to hand back
                        self._q.put(it)
                    raise
            self._held.extend(items)
            while self._held:
                item = self._held.popleft()
                if isinstance(item, tuple) and item[0] is _STOP:
                    stop = item  # submit() refuses after _closed: nothing trails it
                    continue
                self._ready = self._batcher.add(item)
                while self._ready:
                    self._dispatch(self._ready.pop(0))
            if stop is None and self._batcher.due(self._clock(), est):
                self._dispatch(self._batcher.take())
        self._held.extend(self._batcher.take())
        if stop[1]:  # drain: serve what is left so every future resolves
            while self._held and not self._abandon.is_set():
                take, nn = [], 0
                while self._held and (not take or nn + self._held[0].n <= self.max_batch):
                    p = self._held.popleft()
                    take.append(p)
                    nn += p.n
                self._dispatch(take)
        while self._held:  # no drain, or an abandoned one: cancel
            self._cancel(self._held.popleft())

    def _dispatch(self, batch: List[_Pending]) -> None:
        """Expire what already missed its deadline, then serve the rest."""
        if self._abandon.is_set():
            for p in batch:
                self._cancel(p)
            return
        now = self._clock()
        live = []
        for p in batch:
            if p.deadline is not None and now >= p.deadline:
                self._fail(p, DeadlineExceeded(
                    f"deadline missed by {now - p.deadline:.4f}s after {now - p.arrival:.4f}s "
                    "queued (never dispatched)"), kind="expired")
            else:
                live.append(p)
        if live:
            # inside a dispatch from here: a crash fails these, never requeues
            for p in live:
                self._inflight[id(p)] = p
            self._run(live)
            self._inflight.clear()

    def _run(self, batch: List[_Pending]) -> None:
        try:
            if self._faults is not None:
                self._faults.pre_dispatch(batch)  # the plan-exception seam
            # assembled in numpy: the plan set's host path runs no glue op
            # on the card, only the warm bucket's graph
            xs = [p.x for p in batch]
            xb = xs[0] if len(xs) == 1 else np.concatenate(xs, axis=0)
            if self._faults is not None:
                xb = self._faults.pre_serve(batch, xb)  # the slow-plan seam
            t0 = self._clock()
            y = self.serve_batch(xb)  # numpy in, numpy out, complete
            self._note_service_time(self._clock() - t0)
            if self._faults is not None:
                y = self._faults.post_serve(batch, y)  # the NaN-activation seam
        except Exception as e:  # noqa: BLE001 -- isolate, keep the loop alive
            if len(batch) == 1:
                self._fail(batch[0], e, kind="failed")
                return
            # bisect: each half pads to a warm bucket, so the innocent
            # requests complete exactly with no new capture, and the
            # exception ends on the poison request(s) alone
            mid = (len(batch) + 1) // 2
            self._run(batch[:mid])
            self._run(batch[mid:])
            return
        done = self._clock()
        off = 0
        clean = True
        for p in batch:
            yp = y[off: off + p.n]
            off += p.n
            if self._check_outputs and not np.isfinite(yp).all():
                self._fail(p, NumericalFault(
                    f"non-finite logits for a request of {p.n} sample(s)"), kind="failed")
                clean = False
            else:
                self._complete(p, yp, done)
        if clean:
            with self._lock:
                self._degraded = False  # a clean batch clears the flag

    def _complete(self, p: _Pending, y, done: float) -> None:
        self._inflight.pop(id(p), None)
        with self._lock:
            self.stats.latencies_s.append(done - p.arrival)
            self.stats.completed += p.n
            self.stats.last_done = done
            self._depth -= p.n
            self._space.notify_all()
        try:
            p.future.set_result(y)
        except Exception:  # noqa: BLE001 -- cancelled by a racing stop(): already terminal
            pass

    def _fail(self, p: _Pending, exc: Exception, kind: str) -> None:
        self._inflight.pop(id(p), None)
        with self._lock:
            setattr(self.stats, kind, getattr(self.stats, kind) + p.n)
            if kind == "failed":
                self._degraded = True
            self._depth -= p.n
            self._space.notify_all()
        try:
            p.future.set_exception(exc)
        except Exception:  # noqa: BLE001 -- already terminal
            pass

    def _cancel(self, p: _Pending) -> None:
        self._inflight.pop(id(p), None)
        with self._lock:
            self.stats.failed += p.n  # never served; the identity closes
            self._depth -= p.n
            self._space.notify_all()
        p.future.cancel()

    def _crash(self, exc: BaseException) -> None:
        """The dispatcher died: requests inside a dispatch fail with
        :class:`ServerCrashed` (never served twice); admitted but
        undispatched ones go to ``on_crash`` when set, else fail too.
        ``submit`` raises :class:`ServerCrashed` until a restart."""
        with self._lock:
            self._crashed = exc
            self._closed = True
            self._space.notify_all()
        err = ServerCrashed(f"dispatcher crashed: {exc!r}")
        err.__cause__ = exc if isinstance(exc, Exception) else None
        inflight = list(self._inflight.values())
        self._inflight.clear()
        for p in inflight:
            self._fail(p, err, kind="failed")
        # never inside a dispatch: the batches let go of and not yet run, the
        # batcher's, and those taken off the queue in the tick that died
        stranded = [p for batch in self._ready for p in batch] + self._batcher.take()
        stranded += [p for p in self._held if isinstance(p, _Pending)]
        self._ready, self._held = [], deque()
        while True:  # submit() enqueues under the lock: nothing can trail
            try:
                item = self._q.get_nowait()
            except _queue.Empty:
                break
            if not (isinstance(item, tuple) and item[0] is _STOP):
                stranded.append(item)
        if self.on_crash is not None:
            try:
                self.on_crash(exc, stranded)
                return
            except Exception:  # noqa: BLE001 -- a callback error must not strand a waiter
                pass
        for p in stranded:
            self._fail(p, err, kind="failed")


def auto_rate(plan_set, sample_shape: Sequence[int], *, utilization: float = 0.5,
              dtype="float32", reps: int = 5) -> Tuple[float, float]:
    """An offered load from measured capacity: the median host time of
    ``reps`` serves of the largest bucket through the host path (numpy in,
    logits back on the host, so each time includes the card's work), and
    ``(rate, bucket_us)`` with ``rate = utilization * bucket / bucket_time``
    samples/s."""
    cap = plan_set.buckets[-1]
    xb = np.zeros((cap,) + tuple(sample_shape), dtype)
    plan_set.serve(xb)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        plan_set.serve(xb)
        times.append(time.perf_counter() - t0)
    us = float(np.median(times)) * 1e6
    return utilization * cap / (us / 1e6), us
