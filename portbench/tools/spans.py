"""The program's own spans in a cell's traced window, and what a span costs.

  python3 portbench/tools/spans.py --workload <name> --seeds 11,12 [--untraced-seconds 30]
  python3 portbench/tools/spans.py --cost

For each seed: set up the program, run the cell's traced window (its
``trace_seconds``, profiled as a ``--trace 1`` run profiles it), then an
untraced window of ``--untraced-seconds`` (0: none) on the same set-up, and
print one JSON line: each ``repro_torch.*`` span's seconds, count and the
card's idle seconds inside it (``lib/spans.py``), the shares of the window
they come to, the share of the harness's own spans (``portbench.generate``,
``portbench.request``) that the program's spans cover, the busy time with
and without the program's spans' device-side copies, any device operation
of the harness's summary named ``repro_torch.*`` (there should be none),
the device-side copies of either's annotations by kind, and each window's
end-to-end metric. No correctness check.

``--cost``: ns per ``repro_torch.spans.span`` entered and left, with no
profiler and with one recording (the CPU, and the card where there is one),
less an empty loop's.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def window_and_busy(events: list) -> tuple:
    """The window span's (start, end) and the card's merged busy intervals
    in it, as ``trace.reduce_events`` builds them, annotations of the
    harness and of the program left out by name."""
    from portbench.lib import trace
    from portbench.lib.spans import PREFIX

    w0, w1 = next((s, e) for dev, _, name, s, e in events if not dev and name == trace.WINDOW)
    busy = [(max(s, w0), min(e, w1)) for dev, kind, name, s, e in events
            if dev and kind in trace.DEVICE_KINDS and not name.startswith(("portbench.", PREFIX))
            and min(e, w1) > max(s, w0)]
    return w0, w1, trace._merge(busy)


def covered(events: list, outer: str) -> float:
    """The share of the host spans named ``outer`` that the union of the
    program's spans covers."""
    from portbench.lib import trace
    from portbench.lib.spans import PREFIX

    inner = trace._merge([(s, e) for dev, _, name, s, e in events
                          if not dev and name.startswith(PREFIX)])
    total = cover = 0
    for dev, _, name, s, e in events:
        if dev or name != outer:
            continue
        total += e - s
        cover += sum(max(0, min(e, b) - max(s, a)) for a, b in inner)
    return cover / total if total else float("nan")


def traced_row(ctx, untraced_s: float) -> dict:
    """One seed's row (see the module docstring) for the harness's
    ``Context`` of a cell."""
    from portbench.lib import harness, spans, trace

    loop = ctx.cell.loop.Loop(ctx)
    loop.setup()
    harness.sync(ctx.device)
    with trace.Tracer(ctx.device) as tr:
        rec = loop.window(ctx.traffic["trace_seconds"], trace.span)
    events = trace._events(tr._prof)
    w0, w1, busy = window_and_busy(events)
    window_s = (w1 - w0) / 1e9
    red = spans.reduce(events, w0, w1, busy)
    row = {"seed": ctx.seed, "window_s": window_s, "busy_s": tr.summary["busy_s"],
           "busy_s_without_program_spans": sum(e - s for s, e in busy) / 1e9,
           "program_ops_on_device": [n for n in tr.summary["kernels"]
                                     if n.startswith(spans.PREFIX)],
           "device_annotations": sorted({(kind, name) for dev, kind, name, _, _ in events
                                         if dev and name.startswith(("portbench.", spans.PREFIX))}),
           "spans": red, "shares_of_window": {n: 100.0 * v["seconds"] / window_s
                                              for n, v in red.items()},
           "idle_shares": {n: 100.0 * v["idle_seconds"] / v["seconds"]
                           for n, v in red.items() if v["seconds"] > 0},
           "covered": {n: covered(events, n) for n in ("portbench.generate", "portbench.request")},
           "traced_e2e": rec["e2e"], "traced_attempted": rec["attempted"]}
    if untraced_s > 0:
        row["untraced_e2e"] = loop.window(untraced_s, None)["e2e"]
    loop.free()
    return row


def cost(device) -> dict:
    """ns per span, off and recording, less an empty loop's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.spans import span

    def per(n, body):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            body()
        return (time.perf_counter_ns() - t0) / n

    def empty():
        pass

    def one():
        with span("cost"):
            pass

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    base = min(per(200_000, empty) for _ in range(3))
    off = min(per(200_000, one) for _ in range(3)) - base
    with profile(activities=acts):
        on = min(per(20_000, one) for _ in range(3)) - base
    return {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "torch": torch.__version__, "ns_per_span_off": off, "ns_per_span_recording": on,
            "activities": len(acts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--untraced-seconds", type=float, default=0.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from portbench.lib.env import pin_caches

    pin_caches(ROOT)
    import torch

    from portbench.lib import harness

    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    if args.cost:
        print(json.dumps(cost(dev)), flush=True)
    if args.workload:
        if dev.type != "cuda":
            print("spans: no CUDA card", file=sys.stderr)
            return 2
        cell = harness.resolve(args.workload)
        for seed in (int(s) for s in args.seeds.split(",") if s):
            ctx = harness.Context(cell, dict(cell.config), seed, dev)
            print(json.dumps(traced_row(ctx, args.untraced_seconds)), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
