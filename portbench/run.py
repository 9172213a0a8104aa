"""Run one cell of the benchmark once, on the card of the machine it starts on.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` profiles a
window of the traffic's ``trace_seconds`` and reports the per-layer metrics,
the device's busy time and a breakdown. Either way the outputs of the timed
path are compared with the plain reference once the window has closed. The
last line of standard output is the result as one JSON object; each number
compared is printed beside its limit as the last lines of standard error.

Every build and kernel cache stays in the checkout, under ``build/``. The run
fails, printing no result, without a CUDA card, with fewer cards than the
cell asks for, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux: from /proc;
    elsewhere: now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.lib.env import pin_caches

    pin_caches(ROOT)
    import torch

    from portbench.lib import harness, peaks

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card is available (torch.cuda.is_available() is False); "
              "the benchmark runs only on a card and never on the CPU", file=sys.stderr)
        return 2
    chips = cell.entry["chips"]
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    def card():
        harness.log(f"[portbench] card: {power_limit()}; peaks stated (H100 SXM, 700 W): "
                    f"int8 {peaks.INT8_OPS_PER_S:.4g} op/s, bf16 {peaks.BF16_OPS_PER_S:.4g} "
                    f"flop/s, HBM {peaks.HBM_BYTES_PER_S:.4g} B/s")

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                           t_start=T_START, before_checks=card)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
