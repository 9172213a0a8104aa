"""The self-healing serving lifecycle (port of ``repro/launch/supervisor.py``).

:class:`Supervisor` owns a :class:`~repro_torch.launch.server.CNNServer` and
keeps it serving through the failures the request layer cannot absorb: the
dispatcher thread itself dying, the weights on disk going bad, a kernel path
breaking.

- **Restart.** A dispatcher crash hands its admitted but undispatched
  requests to the server's ``on_crash`` seam; the supervisor restarts the
  dispatcher after a bounded exponential backoff with seeded jitter and
  requeues them first, so their futures resolve after the restart.
  Requests that were inside a dispatch fail with ``ServerCrashed``: at most
  once, never run again silently. The restarted server keeps the same
  books (``start(fresh_stats=False)``), so ``completed + rejected + failed
  + expired == submitted`` holds across every restart.
- **Circuit breaker.** More than ``max_restarts`` crashes within
  ``window_s`` open it: the server stays down, :meth:`health` reports
  ``'failed'`` with the reason, and the last crash's requests fail with
  ``ServerCrashed`` instead of looping.
- **Hot reload** (:meth:`reload`). A checkpoint is restored through the
  store's verification (``CorruptCheckpointError`` on any damage, the old
  plan serving on), rebuilt into a plan set off the dispatcher thread,
  warmed (on a card: every bucket captured, under the process's graph
  lock, ``models/plan.py:GRAPH_LOCK``, so the dispatcher pauses for each
  capture) and swapped in between dispatches: nothing dropped, nothing
  hung.
- **Degradation** is the server's per-bucket fallback (``fallback=``,
  ``demote_after``, ``probe_every``); :meth:`health` shows the demoted
  buckets, and ``fallback_builder`` rebuilds the closures on a reload.

The clock and the jitter's seed are injectable, so the backoff and the
breaker are tested without sleeping; every wait is a ``threading.Event``, so
:meth:`stop`, which may be called again, interrupts a backoff at once and
cancels the requests a crash left behind.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from repro_torch.launch.server import CNNServer, ServerCrashed


class Supervisor:
    """Restart, reload and degradation around one ``CNNServer``.

    >>> srv = CNNServer(plan_set, max_wait_ms=5.0)
    >>> sup = Supervisor(srv, rebuild=lambda tree: SparseCNN(cfg).load_state(tree)
    ...                  .plan_set(buckets=plan_set.buckets), template=model.state())
    >>> with sup:
    ...     sup.warmup()
    ...     fut = sup.submit(x)            # the server's
    ...     sup.reload(ckpt_dir)           # a hot swap, nothing dropped
    >>> sup.health()["status"], sup.stats.restarts

    ``max_restarts`` / ``window_s``: more crashes than ``max_restarts``
    within a sliding ``window_s`` open the breaker. ``backoff_s`` /
    ``backoff_max_s`` / ``jitter``: the n-th restart waits
    ``min(backoff_max_s, backoff_s * 2**(n-1))`` stretched by up to
    ``jitter`` of it, drawn from ``seed``. ``rebuild``: a state tree -> a
    plan set, for :meth:`reload`. ``template``: a state tree with the
    checkpoint's structure (what ``checkpoint.store.restore`` fills; its
    leaves' devices are where the restored leaves go). ``fallback_builder``:
    a plan set -> ``{bucket: serve}``, the degradation closures for freshly
    reloaded weights. ``clock``: the breaker's time.

    ``last_reload`` holds the last successful reload's milliseconds
    (``restore``, ``rebuild``, ``capture``: the warmup, ``swap``), and
    ``last_restart`` the last restart's (``backoff``, ``restart``: reaping
    the dead dispatcher, requeueing and starting a new one).
    """

    def __init__(self, server: CNNServer, *, max_restarts: int = 5, window_s: float = 30.0,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0, jitter: float = 0.25,
                 rebuild: Optional[Callable] = None, template=None,
                 fallback_builder: Optional[Callable] = None, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        if max_restarts < 1:
            raise ValueError(f"max_restarts must be >= 1, got {max_restarts}")
        if backoff_s < 0 or backoff_max_s < backoff_s:
            raise ValueError(f"need 0 <= backoff_s <= backoff_max_s, got "
                             f"{backoff_s}/{backoff_max_s}")
        self._srv = server
        server.on_crash = self._on_crash
        self.max_restarts = max_restarts
        self.window_s = float(window_s)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._clock = clock
        self._rebuild = rebuild
        self._template = template
        self._fallback_builder = fallback_builder
        self.reload_failures = 0
        self.last_reload: Optional[dict] = None
        self.last_restart: Optional[dict] = None
        self._lock = threading.Lock()
        self._crash_evt = threading.Event()  # a crash waits for the monitor
        self._wake = threading.Event()       # stop() interrupts a backoff
        self._pending: Optional[tuple] = None  # (exc, stranded requests)
        self._crash_times: List[float] = []
        self._restarting = False
        self._failed_reason: Optional[str] = None
        self._stopped = False
        self._monitor: Optional[threading.Thread] = None

    # ------------------------------------------------------- lifecycle
    def start(self) -> "Supervisor":
        if self._monitor is not None:
            raise RuntimeError("supervisor already started")
        self._stopped = False
        self._failed_reason = None
        self._wake.clear()
        self._crash_evt.clear()
        self._srv.start()  # fresh books for the supervised run
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="cnn-serve-supervisor", daemon=True)
        self._monitor.start()
        return self

    def stop(self, *, drain: bool = True, timeout_s: Optional[float] = None) -> None:
        """Shut down; a second call does nothing more. Interrupts a restart's
        backoff (no hang), stops the server (draining by default), then
        cancels the requests a crash left behind (their waiters get
        ``CancelledError``)."""
        with self._lock:
            self._stopped = True
        self._wake.set()
        self._crash_evt.set()  # wake an idle monitor
        mon, self._monitor = self._monitor, None
        if mon is not None:
            mon.join()
        self._srv.stop(drain=drain, timeout_s=timeout_s)
        # after the server's stop: a dispatcher still crashing has handed its
        # requests to _on_crash by the time its thread is joined
        with self._lock:
            pending, self._pending = self._pending, None
            self._restarting = False  # stopped: no restart follows
        if pending is not None:  # a crash the monitor never took
            self._srv.cancel_pending(pending[1])

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------- restart
    def _on_crash(self, exc: BaseException, stranded: list) -> None:
        """The server's seam, on the dying dispatcher thread: park the crash
        and its undispatched requests for the monitor and return."""
        with self._lock:
            self._pending = (exc, list(stranded))
            self._restarting = True
        self._crash_evt.set()

    def _next_backoff(self, attempt: int) -> float:
        """The delay before restart ``attempt`` (1-based): exponential,
        capped at ``backoff_max_s``, stretched by up to ``jitter``."""
        base = min(self.backoff_max_s, self.backoff_s * 2 ** max(attempt - 1, 0))
        return base * (1.0 + self.jitter * self._rng.random())

    def _breaker_open(self, now: float) -> bool:
        """True when the crash just recorded is the ``max_restarts + 1``-th
        inside the sliding window; older crashes are forgotten."""
        self._crash_times = [t for t in self._crash_times if now - t <= self.window_s]
        return len(self._crash_times) > self.max_restarts

    def _monitor_loop(self) -> None:
        while True:
            self._crash_evt.wait()
            with self._lock:
                if self._stopped:
                    return
                self._crash_evt.clear()
                taken, self._pending = self._pending, None
            if taken is None:
                continue
            exc, stranded = taken
            now = self._clock()
            self._crash_times.append(now)
            if self._breaker_open(now):
                reason = (f"crash loop: {len(self._crash_times)} crashes within "
                          f"{self.window_s}s (last: {exc!r}); circuit breaker open, staying down")
                err = ServerCrashed(reason)
                err.__cause__ = exc if isinstance(exc, Exception) else None
                with self._lock:
                    self._failed_reason = reason
                    self._restarting = False
                self._srv.fail_pending(stranded, err)
                continue  # alive for stop(); the server stays down
            delay = self._next_backoff(len(self._crash_times))
            if self._wake.wait(delay):  # stop() landed during the backoff
                self._srv.cancel_pending(stranded)
                return
            t0 = time.perf_counter()
            try:
                self._srv.stop(drain=False)  # reap the dead dispatcher thread
                if stranded:
                    # requeued before the new dispatcher exists: a crash at
                    # once hands them back through on_crash, never loses them
                    self._srv.requeue(stranded)
                self._srv.start(fresh_stats=False)
                with self._lock:
                    self._srv.stats.restarts += 1
                    self._restarting = False
                    self.last_restart = {"backoff": delay * 1e3,
                                         "restart": (time.perf_counter() - t0) * 1e3}
                faults = getattr(self._srv, "_faults", None)
                if faults is not None and hasattr(faults, "on_restart"):
                    faults.on_restart(self._srv.stats.restarts)
            except Exception as e:  # noqa: BLE001 -- the restart itself failed
                reason = f"restart failed: {e!r}"
                err = ServerCrashed(reason)
                err.__cause__ = e
                with self._lock:
                    self._failed_reason = reason
                    self._restarting = False
                self._srv.fail_pending(stranded, err)

    # ------------------------------------------------------ hot reload
    def reload(self, ckpt_dir, *, step: Optional[int] = None, fallback: bool = False):
        """Verified restore -> rebuild -> warm -> swap.

        Everything before the swap runs on the caller's thread while the
        dispatcher serves the old plan set, and any failure (a
        ``CorruptCheckpointError`` from verification, a rebuild or warmup
        error, another sample spec) leaves the old set serving, counts in
        ``reload_failures`` and is raised. ``fallback=True`` walks back to
        the newest step that verifies. Returns ``(step, fingerprint)`` of
        what serves now."""
        if self._rebuild is None or self._template is None:
            raise RuntimeError("reload needs Supervisor(rebuild=..., template=...)")
        from repro_torch.checkpoint.store import restore

        old_spec = self._srv.plan_set.sample_spec
        t = [time.perf_counter()]
        try:
            tree, manifest = restore(ckpt_dir, self._template, step=step, fallback=fallback)
            t.append(time.perf_counter())
            new_set = self._rebuild(tree)
            t.append(time.perf_counter())
            if old_spec is not None and new_set.sample_spec != old_spec:
                raise ValueError(f"reloaded plan sample spec {new_set.sample_spec} != serving "
                                 f"admission contract {old_spec}")
            new_set.warmup()  # every bucket captured before the swap
            fb = self._fallback_builder(new_set) if self._fallback_builder is not None else None
            t.append(time.perf_counter())
            self._srv.swap_plan_set(new_set, fallback=fb)
            t.append(time.perf_counter())
        except Exception:
            with self._lock:
                self.reload_failures += 1
            raise  # the old plan set still serves: all or nothing
        self.last_reload = {k: (b - a) * 1e3 for k, a, b
                            in zip(("restore", "rebuild", "capture", "swap"), t, t[1:])}
        return manifest["step"], new_set.fingerprint

    # ------------------------------------------------------ delegation
    @property
    def server(self) -> CNNServer:
        return self._srv

    @property
    def stats(self):
        """The supervised run's books: one ``ServerStats`` across every
        restart."""
        return self._srv.stats

    @property
    def restarts(self) -> int:
        return self._srv.stats.restarts

    @property
    def retraces_after_warmup(self) -> int:
        return self._srv.retraces_after_warmup

    def submit(self, x, **kw):
        return self._srv.submit(x, **kw)

    def warmup(self, *a, **kw):
        return self._srv.warmup(*a, **kw)

    def request_timeout_s(self, **kw) -> float:
        return self._srv.request_timeout_s(**kw)

    def health(self) -> dict:
        """The server's snapshot with the lifecycle on top: ``'restarting'``
        between a crash and its restart, ``'failed'`` (with ``reason``) once
        the breaker is open, and the ``restarts``, ``requeued``, ``reloads``
        and ``reload_failures`` counters (``demoted`` is the server's)."""
        base = self._srv.health()
        with self._lock:
            failed = self._failed_reason
            restarting = self._restarting
            stopped = self._stopped
        if failed is not None:
            base["status"] = "failed"
            base["reason"] = failed
        elif restarting:
            base["status"] = "restarting"
        elif stopped and self._monitor is None:
            base["status"] = "stopped"
        base["restarts"] = self._srv.stats.restarts
        base["requeued"] = self._srv.stats.requeued
        base["reloads"] = self._srv.stats.reloads
        base["reload_failures"] = self.reload_failures
        return base
