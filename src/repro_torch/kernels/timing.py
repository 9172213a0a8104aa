"""Device times of calls on the card, for ``chip_smoke.py``,
``kernels/mma_ablation.py`` and ``launch/serve.py``, and the timing harness
the autotuner and the calibration share (port of the reference's
``repro/xla_utils.py``: ``time_samples_us``, ``median_time_us``,
``interleaved_samples_us``, ``interleaved_time_us``, ``noise_frac``). Nothing
here runs at import; :func:`device_ms` needs a CUDA card, :func:`event_ms`
and the harness time a CPU device by the host clock.

The harness's statistics: noise on a shared machine only adds to a sample,
so the min over many samples estimates the true cost more stably than the
median of a few; two programs are compared interleaved (A, B, A, B, …) so
drift cancels out of their ratio.
"""
from __future__ import annotations

import math
import statistics
import time

import torch


def device_ms(fn, keep=lambda name: True, reps: int = 5, passes: int = 3, tries: int = 6):
    """Device time of one call of ``fn``: the CUDA kernels whose names
    ``keep`` accepts, by torch.profiler over ``passes`` passes of ``reps``
    calls each. A pass may deliver only some of its kernel records (on an
    H100, one 95 us kernel once showed one record of five), so a sum over a
    pass would undercount: the time is, for each kernel name, the mean
    duration of its records times its launches per call (the most records
    any pass gave it, over ``reps``, rounded up). Passes can also deliver
    no record at all, three in a row on an H100 once, so while none has
    come, up to ``tries`` more passes are run. None when no pass delivered
    a record."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    durations, most = {}, {}
    for attempt in range(passes + tries):
        if attempt >= passes and durations:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA and keep(ev.name):
                durations.setdefault(ev.name, []).append(ev.time_range.end - ev.time_range.start)
                seen[ev.name] = seen.get(ev.name, 0) + 1
        for name, n in seen.items():
            most[name] = max(most.get(name, 0), n)
    if not durations:
        return None
    us = sum(sum(d) / len(d) * math.ceil(most[name] / reps) for name, d in durations.items())
    return us / 1e3


def event_ms(fn, reps: int = 20, warmup: int = 3, device="cuda") -> float:
    """Mean time of one call of ``fn`` by CUDA events around ``reps``
    back-to-back calls: the device's time when each call outlasts its
    launch, else the host's. On a CPU ``device``, by the host clock."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_STATS = ("median", "min", "p25", "mean")


def _reduce(samples, stat: str) -> float:
    if stat == "median":
        return statistics.median(samples)
    if stat == "min":
        return min(samples)
    if stat == "p25":
        s = sorted(samples)
        return s[max(0, (len(s) - 1) // 4)]
    if stat == "mean":
        return statistics.fmean(samples)
    raise ValueError(f"stat must be one of {_STATS}, got {stat!r}")


def _sampler(device):
    """One timed call of a nullary function, in microseconds: on a CUDA
    ``device`` by CUDA events around the call after a
    ``torch.cuda.synchronize()``; elsewhere by ``time.perf_counter`` around
    the call (the CPU's calls return when they are done)."""
    dev = torch.device(("cuda" if torch.cuda.is_available() else "cpu")
                       if device is None else device)
    if dev.type != "cuda":
        def sample(call):
            t0 = time.perf_counter()
            call()
            return (time.perf_counter() - t0) * 1e6

        return sample
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def sample(call):
        torch.cuda.synchronize(dev)
        start.record()
        call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3

    return sample


def time_samples_us(fn, *args, warmup: int = 1, reps: int = 5, device=None) -> list:
    """Per-call samples of ``fn(*args)`` in microseconds: ``warmup`` untimed
    calls, then ``reps`` timed ones (:func:`_sampler`; ``device`` None: the
    card when there is one)."""
    sample = _sampler(device)
    for _ in range(max(0, warmup)):
        fn(*args)
    return [sample(lambda: fn(*args)) for _ in range(max(1, reps))]


def median_time_us(fn, *args, warmup: int = 1, reps: int = 5, stat: str = "median",
                   device=None) -> float:
    """``stat`` over :func:`time_samples_us`: the median by default; ``'min'``
    over more reps for a noise-robust gate."""
    return _reduce(time_samples_us(fn, *args, warmup=warmup, reps=reps, device=device), stat)


def interleaved_samples_us(fn_a, fn_b, *, warmup: int = 1, reps: int = 5, device=None):
    """``(a_samples, b_samples)`` of two nullary callables sampled
    alternately (A, B, A, B, …) after ``warmup`` untimed pairs."""
    sample = _sampler(device)
    for _ in range(max(0, warmup)):
        fn_a()
        fn_b()
    sa, sb = [], []
    for _ in range(max(1, reps)):
        sa.append(sample(fn_a))
        sb.append(sample(fn_b))
    return sa, sb


def interleaved_time_us(fn_a, fn_b, *, warmup: int = 1, reps: int = 5, stat: str = "median",
                        device=None):
    """``(a_us, b_us)``: ``stat`` over each side of
    :func:`interleaved_samples_us`."""
    sa, sb = interleaved_samples_us(fn_a, fn_b, warmup=warmup, reps=reps, device=device)
    return _reduce(sa, stat), _reduce(sb, stat)


def noise_frac(samples) -> float:
    """How far the lower quartile sits above the min, ``(p25 - min) / min``:
    near 0 on a quiet machine, large when noise reaches the fast samples."""
    lo = min(samples)
    if lo <= 0:
        return 0.0
    return max(0.0, _reduce(samples, "p25") / lo - 1.0)
