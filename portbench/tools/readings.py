"""The readings a cell's correctness limits are set from, many seeds in one
process (set-up is most of a run, so one process saves it once per seed, not
once per process).

  python3 portbench/tools/readings.py --workload <name> --seconds 3 \\
      --seeds 11,12,... --control-seeds 11,12,13

For each seed: set up the program, run a short window of the cell's own
traffic, free the program and compare its sampled outputs with the plain
reference, as a run does; on a control seed also the control: the reference
in the precision below the configuration's, in the program's place, at the
same inputs. Prints a JSON line per seed and, last, the largest program
reading and the smallest control reading of every number. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from portbench.lib.env import pin_caches

    pin_caches(ROOT)
    import torch

    from portbench.lib import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    dev = torch.device("cuda:0")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(
        controls - {int(s) for s in args.seeds.split(",")})
    worst, least = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, dict(cell.config), seed, dev)
        loop = cell.loop.Loop(ctx)
        loop.setup()
        ctx.rec = loop.window(args.seconds, None)
        loop.free()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "program": {c["name"]: c["value"] for c in loop.check()}}
        for k, v in row["program"].items():
            worst[k] = max(worst.get(k, v), v)
        if seed in controls:
            row["control"] = {c["name"]: c["value"] for c in loop.check(control=True)}
            for k, v in row["control"].items():
                least[k] = min(least.get(k, v), v)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del loop, ctx
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": worst, "control_least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
