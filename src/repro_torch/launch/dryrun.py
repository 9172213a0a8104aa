"""Multi-pod dry run: every (arch x shape x mesh) cell's step on a fake
world of 256 or 512 ranks (port of ``repro/launch/dryrun.py``).

For each cell this shows that the distribution is coherent (the specs shard
every leaf, DTensor's redistributions are legal, the step runs end to end
on the production mesh) and records what one rank holds, computes and sends,
for the roofline report. The reference lowers and compiles each cell for 512
fake host devices; the port runs the step once, eagerly, on a fake process
group (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, nothing is sent) as rank 0 of the world, with parameters,
optimizer state, cache and batch as ``meta`` tensors laid out as DTensors by
the port's specs: nothing is allocated and no kernel is launched (a
compressed product on ``meta`` runs the kernel's plain version for its
shape, ``CostCounter.products``). ``cost_utils.CostCounter`` counts the
local ops.

The record keeps the reference's keys (``memory``, ``cost``,
``collectives``, ``micro``), so a roofline reader takes either package's:

  - ``micro``: the step at 1 and 2 pattern groups (the reference's L = 1, 2
    micro-compiles) and the extrapolation ``total = base + delta ·
    (groups + tail / len(pattern) - 1)``. Eager counters see every layer,
    so the per-group delta is exact; the full-depth step is not run (host
    dispatch costs tens of microseconds a DTensor op, minutes a cell). The
    top-level ``cost`` and ``collectives`` are the extrapolated totals.
  - on the multi-pod mesh ``micro`` is skipped, as the reference skips it;
    ``cost`` and ``collectives`` are then one pattern group's step, as the
    reference's scanned program counts its loop body once (``hlo_caveat``).
  - ``memory.argument_bytes``: rank 0's parameters, optimizer state, cache
    and batch at full depth, from their local shard shapes (each dim split
    as DTensor splits it: the first shards take the ceiling); the steps'
    DTensors are checked against the same count. ``temp_bytes``: the
    activation peak (``CostCounter.peak_bytes``), extrapolated as the
    micro terms; on the multi-pod mesh one group's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--sparsity 0.625]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes

The fake world is the process's default group, so each invocation is a
process of its own (a caller that has a world runs the CLI in a
subprocess). Results cache to ``build/dryrun/<cell>.json`` (git-ignored;
``REPRO_DRYRUN_DIR`` overrides); ``--force`` recomputes. A cell that
``cell_runnable`` refuses is ``skipped``; one that raises is ``error``,
with its traceback, and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, cell_runnable, get_config
from repro_torch.configs.shapes import input_specs
from repro_torch.cost_utils import counting
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models.model import LM
from repro_torch.sharding.rules import attn_mode, make_rules

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = pathlib.Path(os.environ.get("REPRO_DRYRUN_DIR", ROOT / "build" / "dryrun"))
METHOD = ("eager step on a fake process group, rank 0, meta tensors as DTensors; local aten "
          "ops counted by cost_utils.CostCounter (flops: torch.utils.flop_counter formulas, "
          "compressed projections 2*M*K_c*N; bytes accessed: inputs plus outputs of every "
          "op, no fusion); collectives: output local bytes of each c10d op, bf16 kept "
          "(tpu_equiv_total_bytes == total_bytes)")


# ------------------------------------------------------------------ world

@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    its rank 0; torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    """The production mesh on the fake world (``device_type='cpu'``)."""
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


# ------------------------------------------------------------- shard sizes

def local_shape(shape, spec, mesh_shape: dict) -> tuple:
    """Rank 0's shard shape of a ``shape`` tensor partitioned by ``spec`` on
    a mesh of ``mesh_shape`` ({axis: size}): each dim over the product of
    its entry's axes, the ceiling where it does not divide (DTensor's
    first shards, ``NamedSharding.shard_shape``'s)."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        k = math.prod(mesh_shape[a] for a in axes)
        out.append(-(-n // k))
    return tuple(out)


def spec_bytes(tree, specs, mesh_shape: dict) -> int:
    """Rank 0's bytes of ``tree`` (tensors, ``meta`` ones included, and
    compressed weights) under the spec tree ``specs``."""
    from repro_torch.core.vdbb import DBBWeight

    if isinstance(tree, dict):
        return sum(spec_bytes(v, specs[k], mesh_shape) for k, v in tree.items())
    if isinstance(tree, DBBWeight):
        return (spec_bytes(tree.values, specs.values, mesh_shape)
                + spec_bytes(tree.indices, specs.indices, mesh_shape))
    return math.prod(local_shape(tree.shape, specs, mesh_shape)) * tree.element_size()


def local_bytes(tree) -> int:
    """The bytes this rank holds of ``tree`` (DTensors by their local
    shards)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.store import flatten

    total = 0
    for x in flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            x = x.to_local() if isinstance(x, DTensor) else x
            total += x.numel() * x.element_size()
    return total


# ------------------------------------------------------------------- cells

def _batch_specs(cfg, shape_name: str, rules: dict) -> tuple:
    """The cell's batch (meta) and the spec of each entry: the batch axis on
    the rules' data axes; train and prefill tokens also along the sequence
    on 'model' (the sequence-parallel residual's layout, as the reference's
    dryrun feeds them)."""
    batch = input_specs(cfg, shape_name)
    kind = SHAPES[shape_name]["kind"]
    dp = rules["batch"]
    specs = {}
    for k, v in batch.items():
        if k == "tokens" and kind != "decode":
            specs[k] = (dp, "model") + (None,) * (v.dim() - 2)
        else:
            specs[k] = (dp,) + (None,) * (v.dim() - 1)
    return batch, specs


def _compressed(cfg) -> bool:
    return bool(cfg.serve_compressed and cfg.dbb is not None)


def state_specs(model, shape_name: str, rules: dict) -> tuple:
    """``(tree, specs)`` of everything the cell's step takes as arguments, at
    the model's depth, as ``meta`` tensors: parameters (compressed for a
    serving cell of a compressed config), the optimizer state (train), the
    cache (decode) and the batch."""
    from repro_torch.optim.adamw import OptConfig, init_state

    sh = SHAPES[shape_name]
    kind = sh["kind"]
    if kind != "train" and _compressed(model.cfg):
        params, pspecs = model.compressed_abstract(), model.compressed_pspecs(rules)
    else:
        params, pspecs = model.abstract(), model.pspecs(rules)
    tree, specs = {"params": params}, {"params": pspecs}
    if kind == "train":
        opt = init_state(params, OptConfig())
        tree["opt"] = opt
        specs["opt"] = {k: (() if k == "count" else pspecs) for k in opt}
    if kind == "decode":
        tree["cache"] = model.cache_abstract(sh["global_batch"], sh["seq_len"])
        specs["cache"] = model.cache_pspecs(rules)
    tree["batch"], specs["batch"] = _batch_specs(model.cfg, shape_name, rules)
    return tree, specs


def _run_step(cfg, shape_name: str, mesh, rules: dict) -> dict:
    """The cell's step once at ``cfg``'s depth under the counters: its
    FLOPs, bytes accessed, transcendentals, collectives and activation
    peak (``temp_bytes``), the seconds, and rank 0's argument bytes from
    its DTensors' local shards beside the specs' count."""
    from repro_torch.core.sparse_linear import PruneSchedule
    from repro_torch.models.common import distribute_tree, sharding_rules
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import make_prefill, make_serve_step, make_train_step

    model = LM(cfg)
    kind = SHAPES[shape_name]["kind"]
    tree, specs = state_specs(model, shape_name, rules)
    args = distribute_tree(tree, specs, mesh)
    model.load_params(args["params"])
    t0 = time.time()
    with sharding_rules(rules, mesh), counting() as c:
        if kind == "train":
            make_train_step(model, OptConfig(), PruneSchedule(0, 1000))(
                args["params"], args["opt"], args["batch"], 0)
        elif kind == "prefill":
            make_prefill(model)(args["batch"])
        else:
            make_serve_step(model)(args["cache"], args["batch"], SHAPES[shape_name]["seq_len"] - 1)
    r = c.record()
    return {"flops": r["flops"], "bytes_accessed": r["bytes accessed"],
            "transcendentals": r["transcendentals"], "collectives": r["collectives"],
            "temp_bytes": r["peak_bytes"], "seconds": round(time.time() - t0, 2),
            "argument_bytes": local_bytes(args),
            "spec_argument_bytes": spec_bytes(tree, specs, _mesh_shape(mesh))}


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def micro_extrapolate(cfg, shape_name: str, mesh, rules: dict) -> dict:
    """Per-rank totals at full depth from the step at 1 and 2 pattern
    groups: ``total(L) = r1 + (r2 - r1) · (groups + tail/len(pattern) - 1)``."""
    pat = len(cfg.pattern)
    r1 = _run_step(dataclasses.replace(cfg, num_layers=pat), shape_name, mesh, rules)
    r2 = _run_step(dataclasses.replace(cfg, num_layers=2 * pat), shape_name, mesh, rules)
    groups_eff = cfg.num_groups + len(cfg.tail_pattern) / pat

    def extrap(a, b):
        return a + (b - a) * (groups_eff - 1), b - a

    flops, flops_g = extrap(r1["flops"], r2["flops"])
    bytes_, bytes_g = extrap(r1["bytes_accessed"], r2["bytes_accessed"])
    c1, c2 = r1["collectives"], r2["collectives"]
    coll, coll_g = extrap(c1["total_bytes"], c2["total_bytes"])
    kinds = sorted(set(c1["bytes"]) | set(c2["bytes"]))
    return {
        "method": "eager L=1,2 pattern-group steps, per-group delta extrapolated (exact: "
                  "eager counters see every layer); " + METHOD,
        "per_device_flops": flops,
        "per_device_bytes": bytes_,
        "per_device_transcendentals": extrap(r1["transcendentals"], r2["transcendentals"])[0],
        "per_device_collective_bytes": coll,
        "per_device_collective_bytes_tpu_equiv": coll,
        "collective_bytes_by_kind": {k: extrap(c1["bytes"].get(k, 0), c2["bytes"].get(k, 0))[0]
                                     for k in kinds},
        "collective_counts_by_kind": {k: extrap(c1["counts"].get(k, 0),
                                                c2["counts"].get(k, 0))[0] for k in kinds},
        "per_group_flops": flops_g,
        "per_group_bytes": bytes_g,
        "per_group_collective_bytes": coll_g,
        "temp_bytes": extrap(r1["temp_bytes"], r2["temp_bytes"])[0],
        "l1": r1,
        "l2": r2,
    }


def cell_rules(cfg, shape_name: str, mesh, multi_pod: bool) -> dict:
    """The cell's rules; the batch replicated where it does not divide the
    data extent (the reference's ``long_500k`` rule)."""
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    rules = make_rules(cfg, tp=tp, multi_pod=multi_pod, mode=SHAPES[shape_name]["kind"])
    dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in rules["batch"])
    if SHAPES[shape_name]["global_batch"] % dp:
        rules = dict(rules, batch=None)
    return rules


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, sparsity=0.625,
               micro: bool = True, cfg=None, mesh=None) -> dict:
    """Run one cell on the fake world this process holds (``mesh``: the
    production mesh by default). Returns its record."""
    cfg = cfg or get_config(arch, sparsity=sparsity)
    ok, reason = cell_runnable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "sparsity": sparsity, "status": "skipped", "reason": reason}
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    rules = cell_rules(cfg, shape_name, mesh, multi_pod)
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    mesh_shape = _mesh_shape(mesh)
    t0 = time.time()
    if micro:
        m = micro_extrapolate(cfg, shape_name, mesh, rules)
        checked = (m["l1"], m["l2"])
        cost = {"flops": m["per_device_flops"], "bytes_accessed": m["per_device_bytes"],
                "transcendentals": m["per_device_transcendentals"]}
        coll = {"bytes": m["collective_bytes_by_kind"], "counts": m["collective_counts_by_kind"],
                "total_bytes": m["per_device_collective_bytes"],
                "tpu_equiv_total_bytes": m["per_device_collective_bytes"]}
        temp = m["temp_bytes"]
    else:
        one = _run_step(dataclasses.replace(cfg, num_layers=len(cfg.pattern)), shape_name,
                        mesh, rules)
        checked = (one,)
        cost = {k: one[k] for k in ("flops", "bytes_accessed", "transcendentals")}
        coll = one["collectives"]
        temp = one["temp_bytes"]
    for r in checked:
        if r["argument_bytes"] != r["spec_argument_bytes"]:
            raise AssertionError(f"rank 0 holds {r['argument_bytes']} argument bytes, the specs "
                                 f"give {r['spec_argument_bytes']}")
    tree, specs = state_specs(LM(cfg), shape_name, rules)
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod, "sparsity": sparsity,
        "status": "ok", "kind": SHAPES[shape_name]["kind"], "attn_mode": attn_mode(cfg, tp),
        "mesh": {k: int(v) for k, v in mesh_shape.items()},
        "chips": int(mesh.size()), "compile_s": round(time.time() - t0, 1),
        "memory": {"argument_bytes": spec_bytes(tree, specs, mesh_shape),
                   "output_bytes": None, "temp_bytes": temp,
                   "generated_code_bytes": None,
                   # each step run: rank 0's DTensors' local bytes and the specs' count
                   "argument_bytes_checked": [{"local": r["argument_bytes"],
                                               "spec": r["spec_argument_bytes"]}
                                              for r in checked]},
        "cost": cost,
        "collectives": coll,
        "method": METHOD,
        "hlo_caveat": ("cost and collectives: the micro extrapolation to full depth" if micro
                       else "cost and collectives: one pattern group's step (micro skipped "
                            "on the multi-pod mesh, as the reference's scanned program counts "
                            "its loop body once)"),
    }
    if micro:
        rec["micro"] = m
    return rec


def cell_key(arch, shape, multi_pod, sparsity) -> str:
    pod = "pod2" if multi_pod else "pod1"
    return f"{arch}__{shape}__{pod}__s{sparsity}"


def run_and_save(arch, shape, *, multi_pod, sparsity=0.625, force=False, micro=True,
                 mesh=None) -> dict:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    key = cell_key(arch, shape, multi_pod, sparsity)
    out = RESULTS_DIR / f"{key}.json"
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        print(f"[cached] {key}: {rec['status']}")
        return rec
    print(f"[run] {key} ...", flush=True)
    try:
        rec = lower_cell(arch, shape, multi_pod=multi_pod, sparsity=sparsity, micro=micro,
                         mesh=mesh)
    except Exception as e:  # noqa: BLE001 -- recorded for triage
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "sparsity": sparsity,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out.write_text(json.dumps(rec, indent=1))
    print(f"  -> {rec['status']}"
          + (f" {rec.get('compile_s')}s" if rec["status"] == "ok" else
             f" ({rec.get('reason', rec.get('error', ''))[:160]})"), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sparsity", default=0.625, type=float)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    sparsity = None if args.dense else args.sparsity
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for mp in meshes:
        shape, axes = PRODUCTION[mp]
        with fake_world(math.prod(shape)):
            mesh = production_mesh(mp)
            for a in archs:
                for s in shapes:
                    rec = run_and_save(a, s, multi_pod=mp, sparsity=sparsity, force=args.force,
                                       micro=not mp, mesh=mesh)
                    counts[rec["status"]] += 1
    print(f"done: {counts['ok']} ok, {counts['skipped']} skipped, {counts['error']} errors")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
