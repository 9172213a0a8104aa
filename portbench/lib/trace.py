"""The traced window: torch.profiler over the window of a ``--trace 1`` run,
reduced to what the per-layer metrics read.

- ``window_s``: the host clock from the window's start to its end (after a
  synchronize); the profiler's events fall inside it.
- ``busy_s``: the union of the intervals in which an operation (a kernel, a
  copy or a fill) ran on the card, clipped to the window.
- ``kernels``: per device operation name, its total seconds and count.
- ``gaps``: the intervals of the window with nothing running on the card,
  each named by the innermost host span or op running at its midpoint.
"""
from __future__ import annotations

import bisect
import time

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def span(name: str):
    """A host span that shows in the trace (a no-op when nothing records)."""
    return torch.profiler.record_function(name)


class Tracer:
    """Context manager around the window: profiles it and reduces the trace
    on exit into ``self.summary``."""

    def __init__(self, device):
        self.device = device
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = span(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(_events(self._prof), window_s)
        return False


def _kind(e, dev: bool) -> str:
    """The event's activity kind; profilers without ``activity_type`` (torch
    2.11) tell only user annotations apart."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    if getattr(e, "is_user_annotation", lambda: False)() or e.name().startswith("portbench."):
        return "gpu_user_annotation" if dev else "user_annotation"
    return "kernel" if dev else "cpu_op"


def _events(prof) -> list:
    """(device: bool, kind, name, start_ns, end_ns) of every event."""
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns(), e.duration_ns()
            else:
                start, dur = e.start_us() * 1000, e.duration_us() * 1000
            out.append((dev, _kind(e, dev), e.name(), start, start + dur))
        return out
    for e in prof.events():  # older profilers: FunctionEvent in microseconds
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((dev, "kernel" if dev else "cpu_op", e.name,
                    int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)))
    return out


def _merge(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events: list, window_s: float) -> dict:
    """The window's summary from raw events (see the module docstring)."""
    win = [(s, e) for dev, _, name, s, e in events if not dev and name == WINDOW]
    if win:
        w0, w1 = win[0]
        window_s = (w1 - w0) / 1e9  # the span's own clock, as the device events'
    else:  # no window span: the events' own extent
        w0 = min(s for *_, s, _ in events)
        w1 = max(e for *_, e in events)
    kernels, intervals = {}, []
    for dev, kind, name, s, e in events:
        if not dev or kind not in DEVICE_KINDS or name.startswith("portbench."):
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
        intervals.append((s, e))
    busy = _merge(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    return {"window_s": window_s, "busy_s": busy_s, "kernels": kernels,
            "gaps": _name_gaps(gaps, events)}


def _name_gaps(gaps: list, events: list, most: int = 5000) -> list:
    """Each gap as (host activity at its midpoint, seconds): the innermost
    host event covering the midpoint (a span of the harness or an op), or
    'host: no span'. Past the ``most`` longest gaps the rest are summed as
    one entry, '(shorter gaps)'."""
    host = sorted((s, e, name) for dev, kind, name, s, e in events
                  if not dev and name != WINDOW and kind in ("cpu_op", "user_annotation"))
    starts = [h[0] for h in host]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:most]:
        mid = (s + e) // 2
        name = "host: no span"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 2000), -1):  # the latest start that covers mid
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out.append((name, (e - s) / 1e9))
    rest = sum(e - s for s, e in gaps[most:])
    if rest:
        out.append(("(shorter gaps)", rest / 1e9))
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    """The trace as the result line carries it: the device operations that
    took most time and the idle time by what the host was doing, each list
    at most ``top`` long, names cut to 160 characters."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    idle = {}
    for name, sec in summary["gaps"]:
        idle[name] = idle.get(name, 0.0) + sec
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v[0]] for n, v in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}


def device_seconds(summary: dict, *patterns) -> tuple:
    """(seconds, launches) of the device operations whose name holds every
    string of one of ``patterns`` (each a tuple of substrings)."""
    secs, count = 0.0, 0
    for name, (s, n) in summary["kernels"].items():
        if any(all(p in name for p in pat) for pat in patterns):
            secs += s
            count += n
    return secs, count

