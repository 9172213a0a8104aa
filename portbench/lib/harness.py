"""Runs one cell once: resolve its files by name, set up the program, run the
window (traced or not), read the metrics, free the program, compare its
outputs with the plain reference, and build the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``portbench/configs/<config>.json``: the model's sizes, its source, its
  cuts, and its plain reference (``references/<reference>.py``);
- ``portbench/traffic/<traffic>.json``: the parameters of one traffic mix,
  read by the loop it names (``loops/<loop>.py``);
- ``portbench/cells/<workload>.json``: the cell's correctness limits;
- ``portbench/metrics/<metric>.py``: one per-layer metric's ``read(ctx)``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from portbench.lib import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    """A module from a file of the benchmark, by path (names may hold dots)."""
    name = "portbench_" + "_".join(path.relative_to(ROOT).with_suffix("").parts).replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench: Path

    @property
    def loop(self):
        return load_module(self.bench / "loops" / f"{self.traffic['loop']}.py")

    @property
    def reference(self):
        return load_module(self.bench / "references" / f"{self.config['reference']}.py")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py")


def cell_metrics(man: dict, name: str) -> tuple:
    """The cell's end-to-end metrics (those without a ``workloads`` key, or
    that list it) and per-layer metrics (those that list it, or without the
    key those that move one of its end-to-end metrics)."""
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def resolve(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    entries = [w for w in man["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    bench = root / "portbench"
    config = json.loads((bench / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((bench / "cells" / f"{name}.json").read_text())
    e2e, per = cell_metrics(man, name)
    return Cell(name, entry, config, traffic, limits, e2e, per, bench)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Context:
    """What a loop and a metric reader see."""

    cell: Cell
    config: dict  # the configuration as run (with any overrides)
    seed: int
    device: torch.device
    faults: frozenset = frozenset()
    rec: Optional[dict] = None  # the window's record
    trace: Optional[dict] = None  # the traced window's summary

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def limits(self) -> dict:
        return self.cell.limits


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, *, t_start: float,
             root: Path = ROOT, overrides: Optional[dict] = None, faults=(),
             before_checks=None) -> dict:
    """One run of cell ``name``: the result line's object. ``t_start`` is the
    process's start on ``time.time()``'s clock; ``overrides`` replace keys of
    the configuration (the CPU tests' small sizes); ``faults`` names faults
    the loop plants in the timed path (the tests of ``correct``);
    ``before_checks`` runs once the program is freed, before the comparison
    (the card's name and power limit, read outside set-up and window)."""
    cell = resolve(name, root)
    dev = torch.device(device)
    ctx = Context(cell, dict(cell.config, **(overrides or {})), seed, dev, frozenset(faults))
    loop = cell.loop.Loop(ctx)
    loop.setup()
    sync(dev)
    setup_s = time.time() - t_start
    log(f"[portbench] {name}: set-up {setup_s:.3f} s")
    if dev.type == "cuda":
        # the window's peak, not set-up's transient copies (dense weights
        # before compression)
        log(f"[portbench] {name}: set-up's memory peak "
            f"{torch.cuda.max_memory_allocated(dev)} bytes")
        torch.cuda.reset_peak_memory_stats(dev)
    if trace:
        with tracing.Tracer(dev) as tr:
            ctx.rec = loop.window(cell.traffic["trace_seconds"], tracing.span)
        ctx.trace = tr.summary
        ops = sorted(ctx.trace["kernels"].items(), key=lambda kv: -kv[1][0])
        for op, (sec, n) in ops[:30]:
            log(f"[portbench] device op {sec:.6f} s in {n} launches: {op}")
    else:
        ctx.rec = loop.window(seconds, None)
    sync(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    for line in ctx.rec.get("info", []):
        log(f"[portbench] {name}: {line}")
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is None:
                log(f"[portbench] {m['name']}: nothing to read in this run")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else ctx.rec["e2e"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    loop.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if before_checks is not None:
        before_checks()
    t0 = time.perf_counter()
    checks = loop.check()
    log(f"[portbench] {name}: reference comparison {time.perf_counter() - t0:.1f} s")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.entry["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": ctx.rec["attempted"], "failed": ctx.rec["failed"],
           "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = ctx.trace["busy_s"]
        info["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = tracing.breakdown(ctx.trace)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        log(f"[portbench] check {c['name']}: {c['value']!r} (limit {c['limit']!r})")
    return out
