"""The port's self-healing serving lifecycle (``repro_torch/launch/supervisor.py``,
the server's demotion and swap, ``models/plan.py:fallback_closures``) on the
CPU: the twin of each of ``tests/test_selfheal.py``'s tests, then a hot
reload from a checkpoint the JAX package wrote, held against its ref-mode
``SparseCNN.apply``, and the old plan set's release after a swap.

The backoff and breaker arithmetic runs on the injected clock and seed.
The integration tests drive real restarts, reloads and demotions through
the ``FaultInjector`` seams, and order their events with
``threading.Event``s (a gate in ``pre_serve``, the supervisor's
``on_restart`` seam, the server's ``on_crash``), never with a wall-clock
bound: ``WAIT_S`` only keeps a broken run from hanging.
"""
import dataclasses
import gc
import threading
import weakref
from concurrent.futures import CancelledError

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import save as jax_save
from repro.configs.cnn import smoke_cnn_config as jsmoke
from repro.models.cnn import SparseCNN as JSparseCNN
from repro_torch.checkpoint.store import CorruptCheckpointError, save
from repro_torch.launch import serve
from repro_torch.launch.faults import FaultInjected, FaultInjector, corrupt_checkpoint
from repro_torch.launch.server import CNNServer, ServerCrashed
from repro_torch.launch.supervisor import Supervisor
from repro_torch.models.cnn import SparseCNN
from repro_torch.models.plan import StalePlanError, fallback_closures
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

WAIT_S = 30  # the longest a test waits for an event it has caused


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class Watch(FaultInjector):
    """A FaultInjector that also reports its kill and the restart after it,
    and can hold the first dispatch at ``pre_serve`` until ``opened``."""

    def __init__(self, *, gate: bool = False, **kw):
        super().__init__(**kw)
        self.killed = threading.Event()
        self.restarted = threading.Event()
        self.entered = threading.Event()
        self.opened = threading.Event()
        if not gate:
            self.opened.set()

    def on_tick(self, n_items):
        try:
            super().on_tick(n_items)
        except FaultInjected:
            self.killed.set()
            raise

    def on_restart(self, restarts):
        super().on_restart(restarts)
        self.restarted.set()

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


def _supervised(plan_set, *, inj=None, **sup_kw):
    srv = CNNServer(plan_set, max_wait_ms=2.0, faults=inj)
    sup_kw.setdefault("backoff_s", 0.001)
    sup_kw.setdefault("backoff_max_s", 0.005)
    return Supervisor(srv, **sup_kw)


def _rebuild(model, buckets):
    """A reload's rebuild: a fresh model loaded with the restored state."""
    return lambda tree: SparseCNN(model.cfg).load_state(tree).plan_set(buckets=buckets)


# ------------------------------------------------- backoff and breaker


def test_backoff_bounded_exponential_with_jitter(served):
    _, _, ps = served
    sup = Supervisor(CNNServer(ps), backoff_s=0.05, backoff_max_s=2.0, jitter=0.25, seed=3)
    delays = [sup._next_backoff(n) for n in range(1, 12)]
    for n, d in enumerate(delays, start=1):
        base = min(2.0, 0.05 * 2 ** (n - 1))
        assert base <= d <= base * 1.25, (n, d)  # jittered, never shrunk
    assert max(delays) <= 2.0 * 1.25
    sup2 = Supervisor(CNNServer(ps), backoff_s=0.05, backoff_max_s=2.0, jitter=0.25, seed=3)
    assert delays == [sup2._next_backoff(n) for n in range(1, 12)]  # the seed replays


def test_breaker_counts_only_crashes_inside_window(served):
    _, _, ps = served
    sup = Supervisor(CNNServer(ps), max_restarts=2, window_s=10.0)
    for t in (0.0, 1.0):
        sup._crash_times.append(t)
        assert not sup._breaker_open(t)
    sup._crash_times.append(2.0)
    assert sup._breaker_open(2.0)  # the third inside the window
    sup2 = Supervisor(CNNServer(ps), max_restarts=2, window_s=10.0)
    for t in (0.0, 1.0, 100.0):
        sup2._crash_times.append(t)
    assert not sup2._breaker_open(100.0)
    assert sup2._crash_times == [100.0]  # pruned to the window


def test_supervisor_validates_config(served):
    _, _, ps = served
    with pytest.raises(ValueError, match="max_restarts"):
        Supervisor(CNNServer(ps), max_restarts=0)
    with pytest.raises(ValueError, match="backoff"):
        Supervisor(CNNServer(ps), backoff_s=1.0, backoff_max_s=0.5)


# --------------------------------------------------------------- restart


def test_restart_requeues_and_books_span_the_crash(served):
    """One transient kill with nine requests queued behind a held dispatch:
    the supervisor restarts, requeues all nine, every future resolves with
    the logits of serving it alone, and one ServerStats balances across the
    restart."""
    _, x, ps = served
    inj = Watch(gate=True, kill_after_dispatches=1, kills=1)
    sup = _supervised(ps, inj=inj)
    with sup:
        sup.warmup()
        futures = [sup.submit(x[:1])]
        assert inj.entered.wait(WAIT_S)  # the first dispatch is held
        futures += [sup.submit(x[i: i + 1]) for i in range(1, 10)]
        inj.opened.set()  # the next tick, with nine queued, dies
        for i, f in enumerate(futures):
            np.testing.assert_array_equal(f.result(timeout=WAIT_S), ps.serve(x[i: i + 1]))
        assert inj.restarted.wait(WAIT_S)
        sup.stats.assert_accounting()
        assert sup.health()["status"] == "ready"
    assert sup.stats.restarts == 1 and inj.restarts == 1 and inj.kills_fired == 1
    assert sup.stats.requeued == 9
    assert sup.retraces_after_warmup == 0
    assert sup.last_restart["restart"] >= 0 and sup.last_restart["backoff"] > 0


def test_crash_loop_opens_breaker_and_fails_typed(served):
    """Every tick with work kills: the requeued request crashes the server
    again after each restart until the breaker opens after max_restarts;
    health is 'failed' with the reason and the request fails typed."""
    _, x, ps = served
    sup = _supervised(ps, inj=FaultInjector(kill_after_dispatches=0), max_restarts=2)
    with sup:
        fut = sup.submit(x[:1])
        with pytest.raises(ServerCrashed, match="crash loop"):
            fut.result(timeout=WAIT_S)
        h = sup.health()
        assert h["status"] == "failed" and "crash loop" in h["reason"]
        assert sup.stats.restarts == 2
        with pytest.raises(ServerCrashed):
            sup.submit(x[:1])  # the server stays down
    sup.stats.assert_accounting()


def test_stop_during_backoff_interrupts_and_cancels(served):
    """stop() during an hour's backoff returns at once, and the stranded
    future is cancelled."""
    _, x, ps = served
    inj = Watch(kill_after_dispatches=0, kills=1)
    sup = _supervised(ps, inj=inj, backoff_s=3600.0, backoff_max_s=3600.0)
    crashed = threading.Event()
    seam = sup.server.on_crash

    def on_crash(exc, pendings):
        seam(exc, pendings)
        crashed.set()

    sup.server.on_crash = on_crash
    sup.start()
    fut = sup.submit(x[:1])
    assert crashed.wait(WAIT_S)
    assert sup.health()["status"] == "restarting"
    stopper = threading.Thread(target=sup.stop)
    stopper.start()
    stopper.join(WAIT_S)
    assert not stopper.is_alive()  # the backoff did not run out
    with pytest.raises(CancelledError):
        fut.result(timeout=1)
    assert sup.stats.restarts == 0 and sup.health()["status"] == "stopped"
    sup.stats.assert_accounting()


def test_stop_is_idempotent(served):
    _, x, ps = served
    sup = _supervised(ps)
    with sup:
        sup.submit(x[:1]).result(timeout=WAIT_S)
    sup.stop()
    sup.stop()
    sup.stats.assert_accounting()


class _MidDispatchKill(FaultInjector):
    """The first dispatch waits at ``pre_serve`` (inside the dispatch, its
    batch marked in flight) until the test has queued more requests; the
    ``die_at``-th dispatch dies with a BaseException, which the dispatch's
    isolation does not catch: the dispatcher itself crashes."""

    def __init__(self, die_at: int = 1):
        super().__init__()
        self.die_at = die_at
        self.entered = threading.Event()
        self.opened = threading.Event()

    def pre_serve(self, pendings, xb):
        xb = super().pre_serve(pendings, xb)
        if not self.entered.is_set():
            self.entered.set()
            self.opened.wait(WAIT_S)
        if self.dispatches == self.die_at:
            raise KeyboardInterrupt("dispatcher died mid-dispatch")
        return xb


def test_at_most_once_inflight_fails_typed_undispatched_requeues(served):
    """The request inside a dispatch when the dispatcher dies fails with
    ServerCrashed (never run again); the one still queued rides the requeue
    and completes after the restart."""
    _, x, ps = served
    inj = _MidDispatchKill()
    sup = _supervised(ps, inj=inj)
    with sup:
        sup.warmup()
        f_inflight = sup.submit(x[:1])
        assert inj.entered.wait(WAIT_S)
        f_queued = sup.submit(x[1:2])
        inj.opened.set()
        with pytest.raises(ServerCrashed):
            f_inflight.result(timeout=WAIT_S)
        np.testing.assert_array_equal(f_queued.result(timeout=WAIT_S), ps.serve(x[1:2]))
        sup.stats.assert_accounting()
    assert sup.stats.restarts == 1 and inj.restarts == 1
    assert sup.stats.requeued == 1 and sup.stats.failed == 1


def test_crash_mid_tick_hands_back_the_rest_of_the_tick(served):
    """Three requests reach the dispatcher in one tick, each a batch of its
    own (max_batch 1), and the first one's dispatch dies: it fails with
    ServerCrashed, and the two the tick had not dispatched are handed back,
    requeued and served (the reference's loop drops them: ROADMAP queue 3)."""
    _, x, ps = served
    inj = _MidDispatchKill(die_at=2)
    sup = Supervisor(CNNServer(ps, max_batch=1, max_wait_ms=2.0, faults=inj),
                     backoff_s=0.001, backoff_max_s=0.005)
    with sup:
        plug = sup.submit(x[:1])
        assert inj.entered.wait(WAIT_S)
        futures = [sup.submit(x[i: i + 1]) for i in range(1, 4)]
        inj.opened.set()
        plug.result(timeout=WAIT_S)
        with pytest.raises(ServerCrashed):
            futures[0].result(timeout=WAIT_S)
        for i, f in enumerate(futures[1:], start=2):
            np.testing.assert_array_equal(f.result(timeout=WAIT_S), ps.serve(x[i: i + 1]))
    assert (sup.stats.restarts, sup.stats.requeued, sup.stats.failed) == (1, 2, 1)
    sup.stats.assert_accounting()


def test_requeue_rejects_crashed_unreaped_server(served):
    """requeue() into a crashed server whose dispatcher is not reaped raises;
    after stop() reaps it, the requeue before start() is allowed."""
    _, x, ps = served
    srv = CNNServer(ps, max_wait_ms=2.0, faults=FaultInjector(kill_after_dispatches=0, kills=1))
    stranded, crashed = [], threading.Event()

    def on_crash(exc, pendings):
        stranded.extend(pendings)
        crashed.set()

    srv.on_crash = on_crash
    with srv:
        srv.submit(x[:1])
        assert crashed.wait(WAIT_S)
        with pytest.raises(RuntimeError, match="reap"):
            srv.requeue(stranded)
        srv.stop(drain=False)
        assert srv.requeue(stranded) == 1
        srv.start(fresh_stats=False)
        np.testing.assert_array_equal(stranded[0].future.result(timeout=WAIT_S),
                                      ps.serve(x[:1]))
    srv.stats.assert_accounting()


# ------------------------------------------------------------ hot reload


def test_hot_reload_swaps_atomically_and_corrupt_leaves_old(served, tmp_path):
    """A verified checkpoint swaps the plan set mid-traffic with no capture
    after warmup; a corrupted latest step fails typed with the old set
    serving the same logits; fallback=True walks back to the step that
    verifies."""
    model, x, ps = served
    save(tmp_path, 1, model.state())
    save(tmp_path, 2, model.state())
    sup = Supervisor(CNNServer(ps, max_wait_ms=2.0), rebuild=_rebuild(model, ps.buckets),
                     template=model.state())
    with sup:
        sup.warmup()
        y0 = sup.submit(x[:1]).result(timeout=WAIT_S)
        step, fp = sup.reload(tmp_path)
        assert step == 2 and fp == ps.fingerprint and sup.server.plan_set is not ps
        np.testing.assert_array_equal(sup.submit(x[:1]).result(timeout=WAIT_S), y0)
        assert sup.retraces_after_warmup == 0
        assert set(sup.last_reload) == {"restore", "rebuild", "capture", "swap"}
        corrupt_checkpoint(tmp_path, step=2, mode="flip")
        serving = sup.server.plan_set
        with pytest.raises(CorruptCheckpointError):
            sup.reload(tmp_path)
        assert sup.reload_failures == 1 and sup.server.plan_set is serving
        np.testing.assert_array_equal(sup.submit(x[:1]).result(timeout=WAIT_S), y0)
        step3, _ = sup.reload(tmp_path, fallback=True)
        assert step3 == 1 and sup.stats.reloads == 2
        assert sup.health()["reloads"] == 2 and sup.health()["reload_failures"] == 1
        sup.stats.assert_accounting()


def test_reload_requires_rebuild_and_template(served, tmp_path):
    _, _, ps = served
    with pytest.raises(RuntimeError, match="rebuild"):
        Supervisor(CNNServer(ps)).reload(tmp_path)


def test_swap_plan_set_validates_ladder(served):
    model, _, ps = served
    with CNNServer(ps, max_wait_ms=2.0) as srv:
        with pytest.raises(ValueError, match="ladder"):
            srv.swap_plan_set(model.plan_set(max_batch=2))


def test_reload_from_a_reference_checkpoint_serves_its_logits(served, tmp_path):
    """The supervised port, serving its own seeded weights, hot-reloads a
    checkpoint the JAX package wrote and then serves the JAX package's
    ref-mode logits on the same params: the stem's codes may move by one
    (fp32 summation order), so within the CNN fixtures' 1e-3 relative L2."""
    model, x, ps = served
    cfg = dataclasses.replace(jsmoke("sparse-cnn-tiny"), kernel_mode="ref")
    jmodel = JSparseCNN(cfg)
    params = jmodel.compress(jmodel.init(jax.random.PRNGKey(3)))
    _, stats = jmodel.apply(params, x[:4], collect_act_stats=True)
    qparams = jmodel.quantize(params, stats)
    jax_save(tmp_path, 1, qparams)
    want = np.asarray(jmodel.apply(qparams, x[:5]))
    sup = Supervisor(CNNServer(ps, max_wait_ms=2.0), rebuild=_rebuild(model, ps.buckets),
                     template=model.state())
    with sup:
        sup.warmup()
        before = sup.submit(x[:5]).result(timeout=WAIT_S)
        step, fp = sup.reload(tmp_path)
        assert step == 1 and fp != ps.fingerprint
        got = sup.submit(x[:5]).result(timeout=WAIT_S)
    assert rel_l2(got, want) <= 1e-3 < rel_l2(before, want)
    assert sup.retraces_after_warmup == 0


def test_reload_lets_the_old_plan_set_go(served, tmp_path):
    """After a swap nothing keeps the replaced plan set alive (on a card its
    graphs and their pool): not the server, its fallback closures, the stats
    or the supervisor."""
    model, x, _ = served
    first = model.plan_set(max_batch=4)
    fb = model.fallback_plan_set(first)
    save(tmp_path, 1, model.state())
    sup = Supervisor(CNNServer(first, max_wait_ms=2.0, fallback=fb),
                     rebuild=_rebuild(model, first.buckets), template=model.state(),
                     fallback_builder=model.fallback_plan_set)
    gone = weakref.ref(first)
    del first, fb
    with sup:
        sup.warmup()
        sup.submit(x[:3]).result(timeout=WAIT_S)
        sup.reload(tmp_path)
        gc.collect()
        assert gone() is None
        sup.submit(x[:3]).result(timeout=WAIT_S)


# ------------------------------------------------------- bucket demotion


def test_demote_after_strikes_probe_repromotes(served):
    """demote_after consecutive failed dispatches demote that bucket alone
    to its fallback (health 'degraded' with the reason); one fault below the
    threshold does not; once healed, the probe_every-th dispatch promotes
    it again."""
    model, x, ps = served
    fallback = model.fallback_plan_set(ps)
    inj = FaultInjector()
    srv = CNNServer(ps, max_wait_ms=2.0, faults=inj, fallback=fallback, demote_after=2,
                    probe_every=2)
    ref3 = ps.serve(x[:3])

    def roundtrip():
        return srv.submit(x[:3]).result(timeout=WAIT_S)

    with srv:
        srv.warmup()
        inj.fail_bucket(4)
        with pytest.raises(FaultInjected):  # strike 1: below the threshold
            roundtrip()
        np.testing.assert_array_equal(roundtrip(), ref3)  # strike 2: demoted, rescued
        assert list(srv.demoted_buckets()) == [4]
        h = srv.health()
        assert h["status"] == "degraded" and 4 in h["demoted"]
        assert "bucket-4" in srv.demoted_buckets()[4]
        assert srv.stats.demotions == 1
        np.testing.assert_array_equal(srv.submit(x[:1]).result(timeout=WAIT_S),
                                      ps.serve(x[:1]))  # the other buckets keep their plans
        inj.heal_bucket(4)
        for _ in range(4):
            np.testing.assert_array_equal(roundtrip(), ref3)
            if not srv.demoted_buckets():
                break
        assert not srv.demoted_buckets() and srv.stats.promotions == 1
        assert srv.health()["status"] == "ready"
        assert srv.retraces_after_warmup == 0
        srv.stats.assert_accounting()
    assert inj.bucket_faults_fired >= 2
    s = srv.stats.summary()
    assert (s["demotions"], s["promotions"]) == (1, 1)


def test_fallback_plan_set_runs_the_same_kernels_without_graphs(served):
    """The fallback restages the serving plan set's own chain, its tile plans
    included, to run without graphs (on a card each kernel launched by its
    wrapper, never a plain version), and every bucket serves bit for bit
    what the primary's serves."""
    model, x, ps = served
    fb = model.fallback_plan_set(ps)
    assert sorted(fb) == list(ps.buckets)
    for b, serve_b in fb.items():
        plan = serve_b.__self__
        assert not plan.graphs and plan.tiles == ps.plans[b].tiles
        xb = np.resize(x, (b,) + x.shape[1:])
        np.testing.assert_array_equal(serve_b(torch.from_numpy(xb)).numpy(), ps.serve(xb))


def test_fallback_closures_pin_fingerprint(served):
    """Closures built from another state than the serving plan set's raise
    StalePlanError: other numbers under 'degraded' would be corruption."""
    model, _, ps = served
    other = SparseCNN(model.cfg).load_state(model.state())
    other.layers()[0].put("b", other.layers()[0].b + 1.0)
    with pytest.raises(StalePlanError):
        fallback_closures(ps, other.plan_set(buckets=ps.buckets, graphs=False))
