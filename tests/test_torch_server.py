"""The port's continuous-batching serving tier (``repro_torch/launch/server.py``,
``launch/faults.py``) on the CPU, over a plan set of ``sparse-cnn-tiny``'s
smoke model (buckets 1, 2, 4).

Ports the server tests of the reference's ``tests/test_serve.py`` and
``tests/test_faults.py``: the micro-batcher, end to end, mixed sizes,
drain and no-drain stop, restart, arrivals, admission, bisection, NaN
poison, overload (reject and block), deadlines, crash, health and the stop
timeout. No test bounds a wall-clock time: the server's clock is injected
where a flush time matters (:class:`Clock`, moved by the test), and a gate
at the ``pre_serve`` seam (:class:`Gate`) holds a dispatch while the test
arranges the queue behind it, so each outcome follows from the order of
events alone.
"""
import threading
from concurrent.futures import CancelledError, Future

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.launch.faults import FaultInjected, FaultInjector, bad_input
from repro_torch.launch.server import (CNNServer, DeadlineExceeded, InvalidRequest,
                                       MicroBatcher, NumericalFault, Overloaded,
                                       ServerCrashed, _Pending, auto_rate, burst_arrivals,
                                       poisson_arrivals, validate_request)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

WAIT_S = 30  # the longest a test waits for an event it has caused


class Clock:
    """The server's clock in a test: each read moves it on by ``step`` (a
    microsecond, so latencies are positive), and :meth:`advance` by more."""

    def __init__(self):
        self.t = 0.0
        self.step = 1e-6
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.t += self.step
            return self.t

    def advance(self, dt: float) -> None:
        with self._lock:
            self.t += dt


class Gate(FaultInjector):
    """Holds the first dispatch at ``pre_serve`` until the test opens the
    gate: ``entered`` is set once the dispatcher waits there."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.entered = threading.Event()
        self.opened = threading.Event()

    def pre_serve(self, pendings, xb):
        xb = super().pre_serve(pendings, xb)
        if not self.entered.is_set():
            self.entered.set()
            self.opened.wait(WAIT_S)
        return xb


@pytest.fixture(scope="module")
def served():
    """A calibrated int8 chain, 12 seeded images (numpy) and a max_batch=4
    plan set."""
    model, _ = serve.build_model("sparse-cnn-tiny", calib_batch=4, device="cpu", smoke=True)
    x = np.random.default_rng(1).normal(size=(12, 16, 16, 3)).astype(np.float32)
    return model, x, model.plan_set(max_batch=4)


def _solo(ps, x):
    """Each request served alone through the bucket-1 plan."""
    return np.concatenate([ps.serve(x[i: i + 1]) for i in range(x.shape[0])])


# ---------------------------------------------------------- the micro-batcher


def _pending(n=1, arrival=0.0, deadline=None):
    return _Pending(x=np.zeros((n, 4)), n=n, arrival=arrival, future=Future(), deadline=deadline)


def test_microbatcher_flushes_at_max_batch():
    mb = MicroBatcher(max_batch=4, max_wait_s=10.0)
    assert [mb.add(_pending()) for _ in range(3)] == [[], [], []]
    flushed = mb.add(_pending())
    assert len(flushed) == 1 and len(flushed[0]) == 4 and len(mb) == 0


def test_microbatcher_max_wait_deadline():
    mb = MicroBatcher(max_batch=8, max_wait_s=0.5)
    assert mb.deadline() is None and not mb.due(99.0)
    mb.add(_pending(arrival=10.0))
    mb.add(_pending(arrival=10.3))
    assert mb.deadline() == pytest.approx(10.5)  # the oldest arrival governs
    assert not mb.due(10.4) and mb.due(10.5)
    assert len(mb.take()) == 2 and mb.deadline() is None


@pytest.mark.parametrize("first,second,flushed_n,left", [(3, 2, [3], 2), (6, None, [6], 0)])
def test_microbatcher_never_splits_a_request(first, second, flushed_n, left):
    """A request that would overflow flushes the batch before it; one above
    max_batch is a batch of its own."""
    mb = MicroBatcher(max_batch=4, max_wait_s=10.0)
    flushed = mb.add(_pending(n=first))
    if second is not None:
        assert flushed == []
        flushed = mb.add(_pending(n=second))
    assert [[p.n for p in b] for b in flushed] == [flushed_n] and len(mb) == left


def test_microbatcher_validates():
    with pytest.raises(ValueError):
        MicroBatcher(0, 1.0)
    with pytest.raises(ValueError):
        MicroBatcher(4, -1.0)


def test_microbatcher_request_deadline_tightens_flush():
    mb = MicroBatcher(max_batch=8, max_wait_s=5.0)
    mb.add(_pending(arrival=10.0))  # max wait: 15.0
    mb.add(_pending(arrival=10.1, deadline=12.0))
    assert mb.deadline() == pytest.approx(12.0)
    assert mb.deadline(service_est_s=0.5) == pytest.approx(11.5)
    assert not mb.due(11.0, service_est_s=0.5) and mb.due(11.5, service_est_s=0.5)


def test_microbatcher_expired_deadline_coexists_with_batch_full():
    """An expired request and a batch-full flush in one add(): the flush
    carries it along in order; the dispatcher expires it."""
    mb = MicroBatcher(max_batch=2, max_wait_s=5.0)
    expired = _pending(arrival=0.0, deadline=1.0)
    mb.add(expired)
    assert mb.due(2.0)
    flushed = mb.add(_pending(arrival=2.0))
    assert len(flushed) == 1 and flushed[0][0] is expired
    assert [p.deadline for p in flushed[0]] == [1.0, None] and not mb.due(99.0)


# ------------------------------------------------------------- end to end


def test_server_end_to_end(served):
    """5 single-image requests, max_batch 4, the clock held: one full
    flush; moving the clock past the max wait flushes the fifth. The
    logits equal serving the five directly, with no capture after warmup."""
    _, x, ps = served
    clock = Clock()
    srv = CNNServer(ps, max_batch=4, max_wait_ms=20.0, clock=clock)
    with srv:
        srv.warmup()
        futures = [srv.submit(x[i: i + 1]) for i in range(5)]
        results = [f.result(timeout=WAIT_S) for f in futures[:4]]
        assert not futures[4].done()
        clock.advance(0.02)
        results.append(futures[4].result(timeout=WAIT_S))
    np.testing.assert_array_equal(np.concatenate(results), ps.serve(x[:5]))
    assert srv.retraces_after_warmup == 0
    s = srv.stats.summary()
    assert s["completed"] == s["offered"] == 5 and s["bucket_counts"] == {"1": 1, "4": 1}
    assert s["p50_us"] > 0 and s["p99_us"] >= s["p50_us"]
    assert s["accounting_ok"] and s["rejected"] == s["failed"] == s["expired"] == 0
    srv.stats.assert_accounting()


def test_server_mixed_request_sizes(served):
    """Requests of 2, 1 and 1 image share one bucket-4 dispatch; 3 more
    images fill a bucket-4 batch with one padded row."""
    _, x, ps = served
    clock = Clock()
    srv = CNNServer(ps, max_wait_ms=20.0, clock=clock)
    with srv:
        srv.warmup()
        futures = [srv.submit(x[0:2]), srv.submit(x[2:3]), srv.submit(x[3:4])]
        results = [f.result(timeout=WAIT_S) for f in futures]
        late = srv.submit(x[4:7])
        clock.advance(0.02)
        results.append(late.result(timeout=WAIT_S))
    assert [r.shape[0] for r in results] == [2, 1, 1, 3]
    np.testing.assert_array_equal(np.concatenate(results), _solo(ps, x[:7]))
    s = srv.stats.summary()
    assert s["bucket_counts"] == {"4": 2} and s["padded_frac"] == pytest.approx(1 / 8)
    srv.stats.assert_accounting()


def test_server_max_wait_bounds_latency(served):
    """A lone request waits for the max wait, not for a full batch."""
    _, x, ps = served
    clock = Clock()
    srv = CNNServer(ps, max_wait_ms=20.0, clock=clock)
    with srv:
        srv.warmup()
        fut = srv.submit(x[:1])
        assert not fut.done()
        clock.advance(0.02)
        fut.result(timeout=WAIT_S)
    assert srv.stats.summary()["bucket_counts"] == {"1": 1}
    assert min(srv.stats.latencies_s) >= 0.02


@pytest.mark.parametrize("drain", [True, False])
def test_server_stop_drains_or_cancels(served, drain):
    """stop() serves what is queued; stop(drain=False) cancels it
    (CancelledError for its waiters). Either way the books close."""
    _, x, ps = served
    srv = CNNServer(ps, max_wait_ms=10_000_000.0)  # never flushes by itself
    srv.start()
    srv.warmup()
    futures = [srv.submit(x[i: i + 1]) for i in range(3)]
    srv.stop(drain=drain)
    assert all(f.done() for f in futures)
    if drain:
        np.testing.assert_array_equal(np.concatenate([f.result() for f in futures]),
                                      ps.serve(x[:3]))
    else:
        for f in futures:
            assert f.cancelled()
            with pytest.raises(CancelledError):
                f.result(timeout=1)
    s = srv.stats.summary()
    assert (s["completed"], s["failed"]) == ((3, 0) if drain else (0, 3))
    srv.stats.assert_accounting()


def test_server_restart_resets_run_state(served):
    """start() after stop() opens new books and re-baselines the captures."""
    _, x, ps = served
    srv = CNNServer(ps, max_wait_ms=1.0)
    srv.start()
    srv.warmup()
    srv.submit(x[:2]).result(timeout=WAIT_S)
    srv.stop()
    assert srv.stats.summary()["completed"] == srv.stats.summary()["offered"] == 2
    srv.start()
    assert srv.stats.summary()["offered"] == 0 and srv.retraces_after_warmup == 0
    out = srv.submit(x[2:3]).result(timeout=WAIT_S)
    srv.stop()
    np.testing.assert_array_equal(out, ps.serve(x[2:3]))
    s = srv.stats.summary()
    assert s["completed"] == s["offered"] == 1 and srv.retraces_after_warmup == 0
    srv.stats.assert_accounting()


def test_server_rejects_when_not_running(served):
    _, x, ps = served
    srv = CNNServer(ps)
    with pytest.raises(RuntimeError):
        srv.submit(x[:1])
    with srv:
        with pytest.raises(InvalidRequest):
            srv.submit(x[:0])


def test_submit_racing_a_crash_is_refused_and_counted(served, monkeypatch):
    """A crash that lands between ``submit``'s admission and its enqueue
    (here inside the request's validation): the request is refused with
    ``ServerCrashed`` and counted as rejected, where it used to be queued
    behind the crash's drain, never to be served or failed (the books
    then missed its samples; seen in ``chip_smoke.py`` 12c's crash loop)."""
    from repro_torch.launch import server as server_mod

    _, x, ps = served
    srv = CNNServer(ps, max_wait_ms=1.0)
    real = server_mod.validate_request

    def crash_then_validate(*a, **kw):
        srv._crash(RuntimeError("the dispatcher died"))
        return real(*a, **kw)

    with srv:
        monkeypatch.setattr(server_mod, "validate_request", crash_then_validate)
        with pytest.raises(ServerCrashed):
            srv.submit(x[:2])
        monkeypatch.setattr(server_mod, "validate_request", real)
        assert srv._q.empty()
    s = srv.stats.summary()
    assert s["offered"] == s["rejected"] == 2
    srv.stats.assert_accounting()


def test_serve_continuous_completes_every_request_exactly(served):
    """The entry point's load loop: Poisson arrivals of mixed-size requests,
    every future resolved with the logits of serving it alone."""
    _, x, ps = served
    rng = np.random.default_rng(6)
    requests = [x[i % 8: i % 8 + int(rng.integers(1, 5))] for i in range(12)]
    out = serve.serve_continuous(ps, requests, rate=2000.0, max_wait_ms=1.0, log=lambda *_: None)
    assert out["failures"] == {} and out["retraces_after_warmup"] == 0
    for r, got in zip(requests, out["results"]):
        np.testing.assert_array_equal(got, _solo(ps, r))
    s = out["summary"]
    assert s["accounting_ok"] and s["completed"] == sum(r.shape[0] for r in requests)


# --------------------------------------------------------------- arrivals


def test_poisson_arrivals_deterministic_and_rate():
    a = poisson_arrivals(100.0, 500, seed=3)
    np.testing.assert_array_equal(a, poisson_arrivals(100.0, 500, seed=3))
    assert (np.diff(a) > 0).all()
    assert a[-1] == pytest.approx(5.0, rel=0.3)  # 500 arrivals at 100 per second
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 4)


def test_burst_arrivals_shape():
    a = burst_arrivals(10, burst=4, gap_s=0.1)
    assert list(a[:4]) == [0.0] * 4 and list(a[4:8]) == [pytest.approx(0.1)] * 4
    assert list(a[8:]) == [pytest.approx(0.2)] * 2
    with pytest.raises(ValueError):
        burst_arrivals(4, burst=0, gap_s=0.1)


def test_auto_rate(served):
    _, x, ps = served
    rate, unit_us = auto_rate(ps, x.shape[1:], utilization=0.5, reps=3)
    assert unit_us > 0 and rate == pytest.approx(0.5 * ps.buckets[-1] / (unit_us / 1e6))


# -------------------------------------------------------------- admission


def test_sample_spec_plumbed_from_config(served):
    _, x, ps = served
    assert ps.sample_spec == (tuple(x.shape[1:]), "float32")


@pytest.mark.parametrize("kind", ["shape", "rank", "dtype", "nan", "inf"])
def test_validate_request_rejects_bad_inputs(served, kind):
    _, x, ps = served
    with pytest.raises(InvalidRequest):
        validate_request(bad_input(kind, x.shape[1:]), ps.sample_spec)
    validate_request(x[:1], ps.sample_spec)


@pytest.mark.parametrize("kind", ["shape", "dtype", "nan"])
def test_submit_rejects_bad_input_alone(served, kind):
    _, x, ps = served
    srv = CNNServer(ps, max_wait_ms=1.0)
    with srv:
        srv.warmup()
        with pytest.raises(InvalidRequest):
            srv.submit(bad_input(kind, x.shape[1:]))
        good = srv.submit(x[:1]).result(timeout=WAIT_S)
    np.testing.assert_array_equal(good, ps.serve(x[:1]))
    s = srv.stats.summary()
    assert (s["rejected"], s["completed"], s["offered"]) == (1, 1, 2)
    srv.stats.assert_accounting()
    assert srv.retraces_after_warmup == 0


def test_submit_rejects_nonpositive_deadline(served):
    _, x, ps = served
    with CNNServer(ps) as srv:
        with pytest.raises(InvalidRequest):
            srv.submit(x[:1], deadline_s=0.0)
    srv.stats.assert_accounting()


# -------------------------------------------------------------- isolation


def _behind_a_plug(srv, gate, reqs):
    """reqs[0] dispatches alone and holds the gate; the rest queue behind it
    and, once the gate opens, dispatch as one batch."""
    futures = [srv.submit(reqs[0])]
    assert gate.entered.wait(WAIT_S)
    futures += [srv.submit(r) for r in reqs[1:]]
    gate.opened.set()
    return futures


@pytest.mark.parametrize("mode,error", [("raise", FaultInjected), ("nan", NumericalFault)])
def test_poison_fails_only_its_request(served, mode, error):
    """A poison in a full co-batch: a plan exception is bisected down to it,
    NaN logits fail it at the output check; every innocent request gets the
    logits of serving it alone, with no capture after warmup."""
    _, x, ps = served
    gate = Gate()
    reqs = [x[i: i + 1] for i in range(5)]  # a plug and a full batch of 4
    gate.poison(reqs[2], mode)
    srv = CNNServer(ps, max_wait_ms=1.0, faults=gate)
    with srv:
        srv.warmup()
        futures = _behind_a_plug(srv, gate, reqs)
        for i, f in enumerate(futures):
            if i == 2:
                with pytest.raises(error):
                    f.result(timeout=WAIT_S)
            else:
                np.testing.assert_array_equal(f.result(timeout=WAIT_S), ps.serve(reqs[i]))
    assert srv.retraces_after_warmup == 0
    s = srv.stats.summary()
    assert (s["completed"], s["failed"]) == (4, 1)
    # the plug alone, then the co-batch: served whole with a NaN row, or
    # bisected into [r1] [r2: raises] [r3, r4]
    assert s["bucket_counts"] == ({"1": 1, "4": 1} if mode == "nan" else {"1": 2, "2": 1})
    srv.stats.assert_accounting()


def test_numerical_fault_from_the_model(served):
    """NaN through the real chain: a NaN bias in the head gives NaN logits,
    so every request fails with NumericalFault and none completes; a NaN
    bias in the last conv is flushed to code 0 at the head's input
    quantize, as in the reference, and the logits stay finite and equal to
    the forward's."""
    _, x, _ = served
    model, _ = serve.build_model("sparse-cnn-tiny", calib_batch=4, device="cpu", smoke=True)
    conv, head = model.layers()[-2], model.layers()[-1]
    conv.b[3] = float("nan")
    with torch.no_grad():
        want = model(torch.from_numpy(x[:3])).numpy()
    assert np.isfinite(want).all()
    with CNNServer(model.plan_set(max_batch=4), max_wait_ms=1.0) as srv:
        srv.warmup()
        got = [srv.submit(x[i: i + 1]).result(timeout=WAIT_S) for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(got), want)
    head.b[7] = float("nan")
    with CNNServer(model.plan_set(max_batch=4), max_wait_ms=1.0) as srv:
        srv.warmup()
        futures = [srv.submit(x[i: i + 2]) for i in range(0, 6, 2)]
        for f in futures:
            with pytest.raises(NumericalFault):
                f.result(timeout=WAIT_S)
    s = srv.stats.summary()
    assert (s["failed"], s["completed"]) == (6, 0)
    srv.stats.assert_accounting()


# --------------------------------------------------------------- overload


def test_overload_reject_sheds_with_retry_after(served):
    _, x, ps = served
    gate = Gate()
    srv = CNNServer(ps, max_wait_ms=1.0, max_queue=2, shed="reject", faults=gate)
    with srv:
        srv.warmup()
        f1 = srv.submit(x[:1])  # in flight at the gate: depth 1
        assert gate.entered.wait(WAIT_S)
        f2 = srv.submit(x[1:2])  # depth 2 == max_queue
        with pytest.raises(Overloaded) as ei:
            srv.submit(x[:1])
        assert ei.value.retry_after_s > 0
        assert srv.health()["status"] == "degraded"  # at capacity
        gate.opened.set()
        f1.result(timeout=WAIT_S)
        f2.result(timeout=WAIT_S)
    s = srv.stats.summary()
    assert s["rejected"] == 1 and s["shed_rate"] > 0
    srv.stats.assert_accounting()


def test_overload_block_backpressures(served):
    """shed='block': the submitter waits for space and is admitted once the
    request in flight completes."""
    _, x, ps = served
    gate = Gate()
    srv = CNNServer(ps, max_wait_ms=1.0, max_queue=1, shed="block", faults=gate)
    admitted = []
    with srv:
        srv.warmup()
        f1 = srv.submit(x[:1])
        assert gate.entered.wait(WAIT_S)
        t = threading.Thread(target=lambda: admitted.append(srv.submit(x[1:2])))
        t.start()
        t.join(0.1)
        assert t.is_alive() and not admitted  # held: the gate keeps f1 in flight
        gate.opened.set()
        f1.result(timeout=WAIT_S)
        t.join(WAIT_S)
        assert not t.is_alive()
        admitted[0].result(timeout=WAIT_S)
    assert srv.stats.summary()["rejected"] == 0
    srv.stats.assert_accounting()


# -------------------------------------------------------------- deadlines


def test_deadline_expires_before_dispatch(served):
    """A request whose deadline passes behind a held dispatch fails with
    DeadlineExceeded and never reaches pre_serve."""
    _, x, ps = served
    clock = Clock()
    gate = Gate()
    srv = CNNServer(ps, max_wait_ms=1.0, faults=gate, clock=clock)
    with srv:
        srv.warmup()
        plug = srv.submit(x[:1])
        clock.advance(0.001)  # past the plug's max wait
        assert gate.entered.wait(WAIT_S)
        doomed = srv.submit(x[1:2], deadline_s=0.05)
        clock.advance(1.0)
        dispatches = gate.dispatches
        gate.opened.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=WAIT_S)
        plug.result(timeout=WAIT_S)
    assert gate.dispatches == dispatches  # only the plug dispatched
    s = srv.stats.summary()
    assert (s["expired"], s["completed"]) == (1, 1)
    srv.stats.assert_accounting()


def test_deadline_met_flushes_early(served):
    """Under a max wait of hours a request with a deadline still flushes,
    at its deadline less the service estimate."""
    _, x, ps = served
    clock = Clock()
    srv = CNNServer(ps, max_wait_ms=1e7, clock=clock)
    with srv:
        clock.step = 0.025  # the warmup's timed dispatch takes 25 ms
        srv.warmup()
        clock.step = 1e-6
        assert srv.service_estimate_s() == pytest.approx(0.025)
        fut = srv.submit(x[:1], deadline_s=0.2)
        clock.advance(0.18)  # past the deadline less the estimate, not the deadline
        out = fut.result(timeout=WAIT_S)
        assert clock.t < 1e4  # long before the max wait
    np.testing.assert_array_equal(out, ps.serve(x[:1]))
    srv.stats.assert_accounting()


# ------------------------------------------------------------ supervision


def test_dispatcher_crash_fails_pending_and_restart_recovers(served):
    _, x, ps = served
    inj = FaultInjector(kill_after_dispatches=0)  # the first tick with work dies
    srv = CNNServer(ps, max_wait_ms=1.0, faults=inj)
    srv.start()
    srv.warmup()
    fut = srv.submit(x[:1])
    with pytest.raises(ServerCrashed):
        fut.result(timeout=WAIT_S)
    with pytest.raises(ServerCrashed):
        srv.submit(x[:1])
    h = srv.health()
    assert h["status"] == "stopped" and h["crashed"]
    assert srv.stats.summary()["failed"] == 1
    srv.stats.assert_accounting()
    srv.stop()
    inj.kill_after_dispatches = None  # the fault is fixed
    srv.start()
    assert srv.stats.summary()["offered"] == 0 and srv.health()["status"] == "ready"
    np.testing.assert_array_equal(srv.submit(x[:1]).result(timeout=WAIT_S), ps.serve(x[:1]))
    assert srv.retraces_after_warmup == 0
    srv.stop()
    srv.stats.assert_accounting()


def test_crash_hands_undispatched_requests_to_on_crash(served):
    """With ``on_crash`` the admitted but undispatched requests of a crash
    are handed back; requeued after a restart that keeps the books open,
    they complete, offered once."""
    _, x, ps = served
    stranded, crashed = [], threading.Event()

    def on_crash(exc, pendings):
        stranded.extend(pendings)
        crashed.set()

    gate = Gate(kill_after_dispatches=1)  # the tick after the plug's dispatch dies
    srv = CNNServer(ps, max_wait_ms=1.0, faults=gate, on_crash=on_crash)
    srv.start()
    srv.warmup()
    futures = _behind_a_plug(srv, gate, [x[i: i + 1] for i in range(4)])
    assert crashed.wait(WAIT_S)
    assert futures[0].result(timeout=WAIT_S) is not None and len(stranded) == 3
    assert not any(f.done() for f in futures[1:])
    srv.stop()
    gate.kill_after_dispatches = None
    assert srv.requeue(stranded) == 3
    srv.start(fresh_stats=False)
    out = np.concatenate([f.result(timeout=WAIT_S) for f in futures])
    srv.stop()
    np.testing.assert_array_equal(out, _solo(ps, x[:4]))
    s = srv.stats.summary()
    assert (s["offered"], s["completed"], s["requeued"]) == (4, 4, 3)
    srv.stats.assert_accounting()


@pytest.mark.parametrize("outcome", ["fail", "cancel"])
def test_fail_or_cancel_pending_closes_the_books(served, outcome):
    _, x, ps = served
    stranded, crashed = [], threading.Event()

    def on_crash(exc, pendings):
        stranded.extend(pendings)
        crashed.set()

    srv = CNNServer(ps, max_wait_ms=1.0, faults=FaultInjector(kill_after_dispatches=0),
                    on_crash=on_crash)
    srv.start()
    fut = srv.submit(x[:1])
    assert crashed.wait(WAIT_S) and len(stranded) == 1
    srv.stop()
    if outcome == "fail":
        srv.fail_pending(stranded, ServerCrashed("kept down"))
        with pytest.raises(ServerCrashed):
            fut.result(timeout=1)
    else:
        srv.cancel_pending(stranded)
        assert fut.cancelled()
    srv.stats.assert_accounting()


def test_health_degrades_on_fault_and_recovers(served):
    _, x, ps = served
    inj = FaultInjector()
    poison = inj.poison(np.array(x[5:6]))
    srv = CNNServer(ps, max_wait_ms=1.0, faults=inj)
    with srv:
        srv.warmup()
        assert srv.health()["status"] == "ready"
        with pytest.raises(FaultInjected):
            srv.submit(poison).result(timeout=WAIT_S)
        assert srv.health()["status"] == "degraded"
        srv.submit(x[:1]).result(timeout=WAIT_S)  # a clean batch clears it
        assert srv.health()["status"] == "ready"
    assert srv.health()["status"] == "stopped"
    srv.stats.assert_accounting()


def test_stop_timeout_abandons_drain(served):
    """Past stop(timeout_s=) the drain gives up: the dispatch in flight
    completes, the queue behind it is cancelled, the books balance."""
    _, x, ps = served
    gate = Gate()
    srv = CNNServer(ps, max_wait_ms=1.0, faults=gate)
    srv.start()
    srv.warmup()
    futures = [srv.submit(x[:1])]
    assert gate.entered.wait(WAIT_S)
    futures += [srv.submit(x[i: i + 1]) for i in range(1, 8)]
    stopper = threading.Thread(target=srv.stop, kwargs=dict(timeout_s=0.0))
    stopper.start()
    assert srv._abandon.wait(WAIT_S)  # the drain is given up before the gate opens
    gate.opened.set()
    stopper.join(WAIT_S)
    assert not stopper.is_alive()
    outcomes = {"done": 0, "cancelled": 0}
    for f in futures:
        try:
            f.result(timeout=1)
            outcomes["done"] += 1
        except CancelledError:
            outcomes["cancelled"] += 1
    assert outcomes == {"done": 1, "cancelled": 7}
    srv.stats.assert_accounting()


def test_concurrent_submitters_keep_the_books(served):
    """16 threads submit at once under a 1 µs switch interval: every
    future resolves with the logits of serving it alone, the books balance
    and no sample is left counted in the queue (a lost update of the
    shared counters would break one of them)."""
    import sys

    _, x, ps = served
    srv = CNNServer(ps, max_wait_ms=1.0)
    results, errors = {}, []

    def client(k):
        try:
            futures = [(i, srv.submit(x[(k + i) % 12: (k + i) % 12 + 1])) for i in range(6)]
            for i, f in futures:
                results[(k, i)] = f.result(timeout=WAIT_S)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with srv:
            srv.warmup()
            threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(results) == 96
    solo = {j: ps.serve(x[j: j + 1]) for j in range(12)}
    for (k, i), got in results.items():
        np.testing.assert_array_equal(got, solo[(k + i) % 12])
    s = srv.stats.summary()
    assert s["completed"] == s["offered"] == 96 and srv.health()["queue_depth"] == 0
    srv.stats.assert_accounting()


# ------------------------------------------------------------- hot swap


def test_swap_plan_set_checks_ladder_and_spec_and_reanchors(served):
    """A swap refuses another bucket ladder or sample spec; an accepted one
    counts a reload, moves the capture baseline to the new set (so a warm
    set swapped in shows no capture after warmup) and serves the new set."""
    model, x, ps = served
    srv = CNNServer(ps, max_wait_ms=1.0)
    with srv:
        srv.warmup()
        with pytest.raises(ValueError, match="ladder"):
            srv.swap_plan_set(model.plan_set(max_batch=2))
        other = model.plan_set(max_batch=4)
        object.__setattr__(other, "sample_spec", ((8, 8, 3), "float32"))
        with pytest.raises(ValueError, match="sample spec"):
            srv.swap_plan_set(other)
        new = model.plan_set(max_batch=4)
        new.warmup()
        srv.swap_plan_set(new)
        assert srv.plan_set is new and srv.retraces_after_warmup == 0
        np.testing.assert_array_equal(srv.submit(x[:3]).result(timeout=WAIT_S), ps.serve(x[:3]))
    assert srv.stats.reloads == 1 and srv.retraces_after_warmup == 0
    srv.stats.assert_accounting()


def test_stats_summary_carries_the_lifecycle_counters():
    from repro_torch.launch.server import ServerStats

    s = ServerStats(submitted=3, completed=3, restarts=1, requeued=2, reloads=3, demotions=1,
                    promotions=1).summary()
    assert {k: s[k] for k in ("restarts", "requeued", "reloads", "demotions", "promotions")} \
        == {"restarts": 1, "requeued": 2, "reloads": 3, "demotions": 1, "promotions": 1}
    assert ServerStats().summary()["reloads"] == 0


@pytest.mark.parametrize("kw,match", [(dict(demote_after=0), "demote_after"),
                                      (dict(probe_every=1), "probe_every")])
def test_server_validates_demotion_knobs(served, kw, match):
    _, _, ps = served
    with pytest.raises(ValueError, match=match):
        CNNServer(ps, **kw)
