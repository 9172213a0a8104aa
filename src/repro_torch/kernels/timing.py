"""Device times of calls on the card, for ``chip_smoke.py``,
``kernels/mma_ablation.py`` and ``launch/serve.py``. Nothing here runs at
import; :func:`device_ms` needs a CUDA card, :func:`event_ms` times a CPU
device by the host clock."""
from __future__ import annotations

import math
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
