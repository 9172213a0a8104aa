"""The port's dry run (``repro_torch/launch/dryrun.py``) and its counters
(``repro_torch/cost_utils.py``) on the CPU.

  - every cell of the reference's production meshes holds what the
    reference's holds: for all 11 configs at full size, each shape, the
    (16, 16) and the (2, 16, 16) mesh, rank 0's bytes of parameters (dense
    at train, compressed for serving), optimizer state, cache and batch
    from the port's specs equal the reference's own pspecs through
    ``NamedSharding(AbstractMesh(...), spec).shard_shape`` (the ceiling
    where a dim does not divide), with no compile and no process group;
  - in a subprocess with a fake (2, 4) world, one smoke-cut cell of each
    attention mode (kv-sharded, q-sharded, context-parallel) at train,
    prefill and decode is ``ok``, with collectives, per-rank FLOPs and
    rank 0's argument bytes equal to the spec-derived count;
  - the per-rank FLOPs: on a one-rank fake world equal to
    ``FlopCounterMode`` over the unsharded step, and on the (2, 4) world
    between the unsharded step's / 8 and its whole;
  - the CLI records a refused cell as ``skipped`` and exits 0.

Each fake world is the default process group of a process of its own.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.models.model import LM as JLM
from repro.optim.adamw import OptConfig as JOpt
from repro.optim.adamw import init_state as jinit_state
from repro.sharding.rules import make_rules as jmake_rules
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models.model import LM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod1": False, "pod2": True}


def _ref_bytes(tree, specs, mesh) -> int:
    """Rank 0's bytes of a reference ShapeDtypeStruct tree under its pspecs."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))

    def leaf(spec, a):
        try:
            shape = NamedSharding(mesh, spec).shard_shape(a.shape)
        except ValueError:  # a dim the spec does not divide: its first shards' ceiling
            shape = []
            for i, n in enumerate(a.shape):
                entry = spec[i] if i < len(spec) else None
                axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
                shape.append(-(-n // math.prod(sizes[x] for x in axes)))
        return math.prod(shape) * np.dtype(a.dtype).itemsize

    return sum(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(leaf, specs, tree, is_leaf=lambda x: isinstance(x, P))))


def _ref_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """The reference's per-category rank-0 bytes of a cell, as its dryrun
    lays the cell out."""
    cfg = jget_config(arch)
    (sizes, names) = PRODUCTION[multi_pod]
    mesh = AbstractMesh(sizes, names)
    sh = JSHAPES[shape]
    kind = sh["kind"]
    rules = jmake_rules(cfg, tp=16, multi_pod=multi_pod, mode=kind)
    dp = math.prod(dict(zip(names, sizes))[a] for a in rules["batch"])
    if sh["global_batch"] % dp:
        rules = dict(rules, batch=None)
    m = JLM(cfg)
    out = {}
    if kind != "train" and cfg.serve_compressed and cfg.dbb is not None:
        params, pspecs = m.compressed_abstract(), m.compressed_pspecs(rules)
    else:
        params, pspecs = m.abstract(), m.pspecs(rules)
    out["params"] = _ref_bytes(params, pspecs, mesh)
    if kind == "train":
        opt = jax.eval_shape(lambda p: jinit_state(p, JOpt()), params)
        out["opt"] = _ref_bytes(opt, {k: (P() if k == "count" else pspecs) for k in opt}, mesh)
    if kind == "decode":
        out["cache"] = _ref_bytes(m.cache_abstract(sh["global_batch"], sh["seq_len"]),
                                  m.cache_pspecs(rules), mesh)
    batch = jinput_specs(cfg, shape)
    bspecs = {k: (P(rules["batch"], "model", *([None] * (v.ndim - 2)))
                  if k == "tokens" and kind != "decode"
                  else P(rules["batch"], *([None] * (v.ndim - 1)))) for k, v in batch.items()}
    out["batch"] = _ref_bytes(batch, bspecs, mesh)
    return out


def _port_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    (sizes, names) = PRODUCTION[multi_pod]
    mesh_shape = dict(zip(names, sizes))

    class Mesh:  # the two methods cell_rules reads
        mesh_dim_names = names

        def size(self, j):
            return sizes[j]

    rules = dryrun.cell_rules(cfg, shape, Mesh(), multi_pod)
    tree, specs = dryrun.state_specs(LM(cfg), shape, rules)
    return {k: dryrun.spec_bytes(tree[k], specs[k], mesh_shape) for k in tree}


def test_the_port_runs_the_reference_cells():
    assert list(ARCHS) == list(JARCHS) and len(ARCHS) == 11
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_per_rank_bytes_match_the_reference_specs(arch, shape, mesh):
    """Rank 0's bytes by category, the port's specs against the reference's."""
    want = _ref_cell(arch, shape, MESHES[mesh])
    got = _port_cell(arch, shape, MESHES[mesh])
    assert got == want


CUT = dict(d_model=64, d_ff=128, vocab_size=512, num_layers=2)
MODES = {"kv_sharded": ("codeqwen1.5-7b", {}), "q_sharded": ("qwen2-72b", {}),
         "context": ("starcoder2-7b", dict(num_heads=6, num_kv_heads=2))}

FAKE_WORLD = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh

    shape, axes = tuple(json.loads(sys.argv[1])), ("data", "model")
    modes = json.loads(sys.argv[2])
    cut = json.loads(sys.argv[3])
    out = {}

    def unsharded(cfg, shape_name):
        # the step on plain meta tensors, no mesh: FlopCounterMode's global count
        from repro_torch.core.sparse_linear import PruneSchedule
        from repro_torch.models.model import LM
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.train.step import make_prefill, make_serve_step, make_train_step
        from repro_torch.sharding.rules import make_rules
        model = LM(cfg)
        rules = make_rules(cfg, tp=1, mode=dr.SHAPES[shape_name]["kind"])
        tree, _ = dr.state_specs(model, shape_name, rules)
        model.load_params(tree["params"])
        batch = {k: v.long() if not v.is_floating_point() else v for k, v in tree["batch"].items()}
        from repro_torch.cost_utils import CostCounter
        # the compressed products' plain versions on meta, as the dry run takes them
        with CostCounter().products(), FlopCounterMode(display=False) as fc:
            kind = dr.SHAPES[shape_name]["kind"]
            if kind == "train":
                make_train_step(model, OptConfig(), PruneSchedule(0, 1000))(
                    tree["params"], tree["opt"], batch, 0)
            elif kind == "prefill":
                make_prefill(model)(batch)
            else:
                make_serve_step(model)(tree["cache"], batch, dr.SHAPES[shape_name]["seq_len"] - 1)
        return fc.get_total_flops()

    n = shape[0] * shape[1]
    with dr.fake_world(n):
        mesh = make_mesh(shape, axes, device_type="cpu")
        for mode, (arch, extra) in modes.items():
            cfg = dataclasses.replace(smoke_config(arch), **cut, **extra)
            for s in ("train_4k", "prefill_32k", "decode_32k"):
                rules = dr.cell_rules(cfg, s, mesh, False)
                one = dr._run_step(dataclasses.replace(cfg, num_layers=1), s, mesh, rules)
                rec = dr.lower_cell(arch, s, multi_pod=False, cfg=cfg, mesh=mesh)
                out[f"{mode}/{s}"] = {
                    "status": rec["status"], "attn_mode": rec["attn_mode"],
                    "flops": one["flops"], "collectives": one["collectives"]["counts"],
                    "argument_bytes": one["argument_bytes"],
                    "spec_argument_bytes": one["spec_argument_bytes"],
                    "global": unsharded(dataclasses.replace(cfg, num_layers=1), s),
                    "micro": "micro" in rec, "cost_flops": rec["cost"]["flops"]}
    print(json.dumps(out))
""")


def _fake_world(shape, modes) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", FAKE_WORLD, json.dumps(shape), json.dumps(modes),
                          json.dumps(CUT)], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout[-3000:]}\nSTDERR:\n{out.stderr[-6000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_fake_world_cells_in_every_mode():
    """(2, 4): each mode's train, prefill and decode cell ``ok`` in its own
    mode, with collectives; one group's per-rank FLOPs between the
    unsharded step's / 8 and its whole; the arguments' local bytes equal
    the spec-derived count."""
    got = _fake_world((2, 4), MODES)
    assert len(got) == 9
    for key, r in got.items():
        mode = key.split("/")[0]
        assert r["status"] == "ok" and r["attn_mode"] == mode, (key, r)
        assert sum(r["collectives"].values()) > 0, (key, r)
        assert r["global"] / 8 <= r["flops"] <= r["global"], (key, r)
        assert r["argument_bytes"] == r["spec_argument_bytes"], (key, r)
        assert r["micro"] and r["cost_flops"] > r["flops"], (key, r)


def test_one_rank_flops_equal_the_unsharded_count():
    """On a one-rank fake world the per-rank FLOPs (local ops, compressed
    projections at 2·M·K_c·N) equal ``FlopCounterMode`` over the unsharded
    step, whose plain version contracts the compressed K too."""
    got = _fake_world((1, 1), {"kv_sharded": MODES["kv_sharded"]})
    for key, r in got.items():
        assert r["status"] == "ok"
        assert r["flops"] == r["global"], (key, r)


def test_cli_skips_a_refused_cell(tmp_path):
    """``long_500k`` of a full-attention arch: ``cell_runnable`` refuses it,
    the record says ``skipped`` with the reason, the CLI exits 0."""
    env = dict(os.environ, REPRO_DRYRUN_DIR=str(tmp_path), PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen2-72b", "--shape", "long_500k"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen2-72b__long_500k__pod1__s0.625.json").read_text())
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
    assert "done: 0 ok, 1 skipped, 0 errors" in out.stdout


def test_cost_counter_counts_products_once():
    """``cost_analysis_dict`` of a dense and a compressed product: the dense
    one at 2·M·K·N with its operands' and output's bytes, the compressed one
    at 2·M·K_c·N however its plain version computes it (its insides
    uncounted), a softmax's outputs as transcendentals; ``op_breakdown``
    counts the ops by name."""
    import torch

    from repro_torch.core.vdbb import DBBFormat, dbb_encode, dbb_prune
    from repro_torch.cost_utils import cost_analysis_dict, op_breakdown
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    a, w = torch.randn(6, 32, generator=g), torch.randn(32, 16, generator=g)
    fmt = DBBFormat(8, 3, "matrix")
    cw = dbb_encode(dbb_prune(w, fmt), fmt)

    def fn():
        torch.softmax(a @ w, dim=-1)
        ops.vdbb_matmul(a, cw)

    c = cost_analysis_dict(fn)
    assert c["flops"] == 2 * 6 * 32 * 16 + 2 * 6 * (32 // 8 * 3) * 16
    assert c["transcendentals"] == 6 * 16
    dense = (6 * 32 + 32 * 16 + 6 * 16) * 4
    assert c["bytes accessed"] >= dense + 2 * 6 * 16 * 4
    assert c["collectives"]["total_bytes"] == 0 and c["peak_bytes"] > 0
    ob = op_breakdown(fn)
    assert ob["ops"]["vdbb_matmul"] == 1 and ob["ops"]["aten.mm.default"] == 1
    assert ob["n_ops"] == sum(ob["ops"].values()) and ob["flops"] == c["flops"]
