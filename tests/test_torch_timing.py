"""The port's timing harness (``repro_torch/kernels/timing.py``) against the
reference's (``repro/xla_utils.py``), the twin of ``tests/test_timing.py``.

On a CPU device a sample is one call between two ``time.perf_counter``
reads, as the reference's, so both run on the same scripted clock here and
must give the same samples, statistics, A/B order and noise estimate. Then
the autotuner's confirmation pass (``autotune._search``) through fake
timers: a winner that does not repeat its win by ``CONFIRM_MARGIN`` is
demoted to the default, as the reference's."""
import pytest

from repro import xla_utils
from repro.kernels import autotune as jat
from repro.kernels import core as jcore
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import core as tcore
from repro_torch.kernels import timing
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


class FakeTime:
    """Scripted ``perf_counter``: each timed sample consumes one duration
    (µs) from the queue; the first call opens the sample, the second closes
    it."""

    def __init__(self, durations_us):
        self.durations = list(durations_us)
        self._now = 0.0
        self._open = None

    def perf_counter(self):
        if self._open is None:
            self._open = self.durations.pop(0) * 1e-6
            return self._now
        self._now += self._open
        self._open = None
        return self._now


@pytest.fixture()
def clocks(monkeypatch):
    """Install the same script on both harnesses (the reference's
    ``block_until_ready`` passes values through)."""
    import jax

    monkeypatch.setattr(jax, "block_until_ready", lambda v: v)

    def install(durations_us):
        port, ref = FakeTime(durations_us), FakeTime(durations_us)
        monkeypatch.setattr(timing, "time", port)
        monkeypatch.setattr(xla_utils, "time", ref)
        return port, ref

    return install


def test_median_of_k_and_warmup_exclusion(clocks):
    port, ref = clocks([100.0, 300.0, 200.0])
    calls = []
    t = timing.median_time_us(lambda: calls.append(1), warmup=2, reps=3, device="cpu")
    assert t == xla_utils.median_time_us(lambda: None, warmup=2, reps=3) == pytest.approx(200.0)
    assert len(calls) == 5 and port.durations == ref.durations == []


@pytest.mark.parametrize("stat", ["median", "min", "p25", "mean"])
def test_every_stat_equals_the_reference(clocks, stat):
    clocks([400.0, 100.0, 300.0, 200.0, 250.0])
    got = timing.median_time_us(lambda: None, warmup=0, reps=5, stat=stat, device="cpu")
    assert got == xla_utils.median_time_us(lambda: None, warmup=0, reps=5, stat=stat)


def test_samples_equal_the_reference(clocks):
    clocks([400.0, 100.0, 300.0, 200.0])
    got = timing.time_samples_us(lambda: None, warmup=0, reps=4, device="cpu")
    assert got == xla_utils.time_samples_us(lambda: None, warmup=0, reps=4)
    assert got == pytest.approx([400.0, 100.0, 300.0, 200.0])


def test_unknown_stat_raises():
    with pytest.raises(ValueError, match="stat"):
        timing._reduce([1.0], "p999")
    assert timing._STATS == xla_utils._STATS


def test_args_forwarded(clocks):
    clocks([10.0])
    got = []
    timing.time_samples_us(lambda a, b: got.append((a, b)), "x", 7, warmup=0, reps=1,
                           device="cpu")
    assert got == [("x", 7)]


def test_interleaved_order_and_routing_equal_the_reference(clocks):
    clocks([10.0, 20.0, 30.0, 40.0])
    order = []
    sa, sb = timing.interleaved_samples_us(lambda: order.append("a"), lambda: order.append("b"),
                                           warmup=1, reps=2, device="cpu")
    assert order == ["a", "b", "a", "b", "a", "b"]  # the warm-up pair first
    assert (sa, sb) == xla_utils.interleaved_samples_us(lambda: None, lambda: None, warmup=1,
                                                        reps=2)
    assert sa == pytest.approx([10.0, 30.0]) and sb == pytest.approx([20.0, 40.0])


@pytest.mark.parametrize("stat", ["median", "min"])
def test_interleaved_stat_equals_the_reference(clocks, stat):
    clocks([100.0, 300.0, 200.0, 400.0, 150.0, 350.0])
    got = tat.interleaved_medians(lambda: None, lambda: None, warmup=0, reps=3, stat=stat,
                                  device="cpu")
    assert got == jat.interleaved_medians(lambda: None, lambda: None, warmup=0, reps=3,
                                          stat=stat)


@pytest.mark.parametrize("samples", [[100.0] * 4, [100.0, 150.0, 200.0, 250.0, 300.0, 350.0,
                                                   400.0, 450.0], [0.0, 10.0]])
def test_noise_frac_equals_the_reference(samples):
    assert timing.noise_frac(samples) == xla_utils.noise_frac(samples)


# ---------------------------------------------------------------------------
# the confirmation pass through fake timers
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _clean_registry():
    tcore.clear_tuned()
    jcore.clear_tuned()
    yield
    tcore.clear_tuned()
    jcore.clear_tuned()


def _run_search(monkeypatch, mod, core, winner, default, *, confirm):
    """``_search`` of ``mod`` with fake timers: ``winner`` measures 50 us, the
    default 100; ``confirm`` scripts the interleaved head-to-head."""
    sig = core.matmul_sig(64, 128, 96, 8, 3, "int8")
    monkeypatch.setattr(mod, "median_time_us",
                        lambda fn, *a, **k: 50.0 if fn() == winner else 100.0)
    monkeypatch.setattr(mod, "interleaved_medians", lambda *a, **k: confirm)
    return mod._search(core.KIND_MATMUL_TC, sig, [winner, default], cost_fn=lambda t: 0.0,
                       build=lambda t: (lambda: t), default_tiles=default, top_k=2, reps=3,
                       warmup=1, cache=None, save=False)


@pytest.mark.parametrize("confirm,kept", [((50.0, 100.0), True), ((98.0, 100.0), False),
                                          ((95.0, 100.0), True), ((95.3, 100.0), False)])
def test_demotion_at_the_margin_equals_the_reference(monkeypatch, confirm, kept):
    """A winner that does not repeat its win by ``CONFIRM_MARGIN`` (95 *
    1.05 = 99.75 <= 100 keeps it, 95.3 * 1.05 > 100 does not) is demoted,
    on both sides, with the same times; what is kept is installed."""
    assert tat.CONFIRM_MARGIN == jat.CONFIRM_MARGIN
    got = _run_search(monkeypatch, tat, tcore, {"tile_rows": 64}, {"tile_rows": 128},
                      confirm=confirm)
    want = _run_search(monkeypatch, jat, jcore, {"bm": 1}, {"bm": 2}, confirm=confirm)
    assert (got.tiles == {"tile_rows": 64}) == (want.tiles == {"bm": 1}) == kept
    assert (got.measured_us, got.default_us) == (want.measured_us, want.default_us)
    assert got.measured_us <= got.default_us
    assert tcore.lookup_tiles(tcore.KIND_MATMUL_TC, got.sig) == got.tiles
