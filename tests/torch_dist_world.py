"""A gloo world of CPU processes for ``tests/test_torch_distributed.py``.

    python tests/torch_dist_world.py CASE WORKDIR NPROCS

starts NPROCS ranks (``torch.multiprocessing.spawn``), each with one torch
thread, joined through a rendezvous file in WORKDIR (no fixed port, so
worlds of parallel test workers never meet) and a 120 s collective timeout.
Every rank runs ``CASE`` on the inputs the parent left in
``WORKDIR/input.pt``; rank 0 writes what it returns to
``WORKDIR/result.pt``; every rank tears its process group down on every
path. A failing rank fails the command.

Cases (the mesh is ``(2, 4)`` ``("data", "model")``, the reference's own test
mesh, unless stated):
  train      the sharded ``Trainer`` (the launcher's path) for 2 steps, of
             ``smoke_cut(arch)`` with ``inp["extra"]`` replaced
  decode     the sharded compressed decode step, counting the tc kernel's
             plain-version calls and every densifying call
  constrain  ``LM.constrain`` on parameters sharded by the training rules
  embed      the vocab-sharded embedding lookup under ``CommDebugMode``
  restore    a checkpoint saved from ``(2, 4)``, restored onto ``(4, 2)``
             and ``(1, 8)``
  resume     ``Trainer`` from its own init on ``(2, 4)``, resumed on ``(4, 2)``
  launch     ``launch.train --distributed`` in a 2-rank world
  serve      prefill and two compressed decode steps of ``inp["cfg"]`` in its
             attention mode at tp 4 (q-sharded or context-parallel), the
             collectives of each decode step counted by ``cost_utils``
  family     one family of ``tests/test_torch_distributed_families.py``:
             ``inp["cfg"]``'s sharded ``Trainer`` for ``inp["train"]``
             steps and one more loss step with its collectives logged, then a
             compressed prefill and a decode step for each
             token of ``inp["feed"]``
             with every collective's kind, group and output shape logged
  nll        ``models.model.vocab_nll`` on logits split along the vocab over
             each of ``inp["layouts"]``, forward and backward
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
MESH = ((2, 4), ("data", "model"))
CUT = dict(d_model=64, d_ff=128, vocab_size=512, num_layers=2)  # the reference test's


def smoke_cut(arch: str):
    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(arch), **CUT)


def _mesh(shape=MESH[0], axes=MESH[1]):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, device_type="cpu")


def _full_tree(tree):
    """The logical tensors of ``tree``, copied (a replicated leaf's full
    tensor is its local one, which a later step updates in place)."""
    from repro_torch.checkpoint.store import flatten, full_tensor, unflatten

    return unflatten(tree, [full_tensor(x).detach().clone() for x in flatten(tree)[0]])


# ------------------------------------------------------------------ cases

def case_train(inp):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.common import distribute_tree
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.loop import LoopConfig, Trainer

    mesh = _mesh()
    m = LM(dataclasses.replace(smoke_cut(inp["arch"]), **inp.get("extra", {})))
    rules = make_rules(m.cfg, tp=4, mode="train")
    params = distribute_tree(inp["params"], m.pspecs(rules), mesh)
    opt = OptConfig(**inp["opt"])
    t = Trainer(m, opt, DataConfig(**inp["data"]), LoopConfig(total_steps=inp["steps"],
                                                               log_every=1),
                device="cpu", mesh=mesh, rules=rules)
    norms = []
    step_fn = t.step_fn

    def spy(*a):
        out = step_fn(*a)
        norms.append(float(out[2]["grad_norm"]))
        return out

    t.step_fn = spy
    out, state, history = t.run(params, init_state(params, opt), 0)
    placed = {str(tuple(x.placements)) for x in _leaves(out)}
    return {"params": _full_tree(out), "history": history, "grad_norms": norms,
            "placements": sorted(placed), "state": _full_tree(state)}


def _leaves(tree):
    from repro_torch.checkpoint.store import flatten

    return flatten(tree)[0]


def case_decode(inp):
    from repro_torch.core import vdbb
    from repro_torch.kernels import vdbb_matmul as vm
    from repro_torch.models.common import distribute, distribute_tree, sharding_rules
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.step import make_serve_step
    from torch.distributed.tensor import DTensor

    mesh = _mesh()
    m = LM(inp["cfg"])
    m.load_params(inp["params"]).compress()
    rules = make_rules(m.cfg, tp=4, mode="decode")
    m.distribute(mesh, rules)
    b, cap = inp["cache"]
    cache = distribute_tree(m.init_cache(b, cap), m.cache_pspecs(rules), mesh)
    calls, dense, products = [], [], []
    plain = vm.vdbb_matmul_tc_plain
    matmul = torch.Tensor.__matmul__

    inside = []

    def spy(a, values, indices, fmt, **kw):
        calls.append((tuple(a.shape), tuple(values.shape),
                      isinstance(a, DTensor) or isinstance(values, DTensor)))
        inside.append(1)
        try:  # the plain version's own product is over the compressed K
            return plain(a, values, indices, fmt, **kw)
        finally:
            inside.pop()

    def densify(*a, **kw):
        dense.append(1)
        raise AssertionError("a compressed weight was densified")

    def product(a, w):
        if not inside:
            products.append(tuple(w.shape))
        return matmul(a, w)

    from repro_torch.models import attention

    vm.vdbb_matmul_tc_plain = spy
    vdbb.dbb_decode = vdbb.dbb_matmul_ref = attention.dbb_decode = densify
    torch.Tensor.__matmul__ = product
    tokens = distribute(inp["tokens"], mesh, (rules["batch"], None))
    try:
        with sharding_rules(rules, mesh):
            logits, _ = make_serve_step(m)(cache, {"tokens": tokens}, inp["pos"])
    finally:
        torch.Tensor.__matmul__ = matmul
    placements = str(tuple(logits.placements))
    return {"logits": logits.full_tensor(), "calls": calls, "densified": len(dense),
            "products": products, "placements": placements}


def case_serve(inp):
    from repro_torch.checkpoint.store import full_tensor
    from repro_torch.cost_utils import counting
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models.common import distribute, distribute_tree, sharding_rules
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import attn_mode, make_rules
    from repro_torch.train.step import make_prefill, make_serve_step

    mesh = _mesh()
    m = LM(inp["cfg"])
    m.load_params(inp["params"]).compress()
    prompt = inp["prompt"]
    b, plen = prompt.shape
    rules = make_rules(m.cfg, tp=4, mode="prefill")
    m.distribute(mesh, rules)
    tokens = distribute(prompt, mesh, (rules["batch"], "model"))
    with sharding_rules(rules, mesh):
        logits, cache = make_prefill(m)({"tokens": tokens})
    out = {"mode": attn_mode(m.cfg, 4), "prefill": full_tensor(logits), "steps": [],
           "collectives": []}
    cache = {k: v for k, v in cache.items()}
    full = pad_cache(_full_tree(cache), plen, inp["cap"])
    rules = make_rules(m.cfg, tp=4, mode="decode")
    m = LM(inp["cfg"]).load_params(inp["params"]).compress().distribute(mesh, rules)
    specs = m.cache_pspecs(rules)
    cache = distribute_tree(full, specs, mesh)
    out["cache_placements"] = str(tuple(cache["groups"]["b0"]["k"].placements))
    out["cache_local"] = tuple(cache["groups"]["b0"]["k"].to_local().shape)
    tok = logits.full_tensor()[:, -1:].argmax(-1)
    step = make_serve_step(m)
    for i in range(2):
        with sharding_rules(rules, mesh), counting() as c:
            lg, cache = step(cache, {"tokens": distribute(tok, mesh, (rules["batch"], None))},
                             plen + i)
        lg = full_tensor(lg)
        out["steps"].append(lg)
        out["collectives"].append({**c.record()["collectives"], "shapes": c.coll_shapes})
        tok = lg[:, -1:].argmax(-1)
    out["cache"] = _full_tree(cache)
    return out


def case_constrain(inp):
    from repro_torch.models.common import distribute_tree
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import make_rules

    mesh = _mesh()
    m = LM(smoke_cut(inp["arch"]))
    rules = make_rules(m.cfg, tp=4, mode="train")
    m.load_params(distribute_tree(inp["params"], m.pspecs(rules), mesh))
    m.constrain()
    return {"params": _full_tree(m.params)}


def case_embed(inp):
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.common import (distribute, sharded_embed_lookup,
                                           sharding_rules)
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import make_rules

    mesh = _mesh()
    m = LM(smoke_cut("codeqwen1.5-7b"))
    out = {}
    for mode in ("train", "decode"):
        rules = make_rules(m.cfg, tp=4, mode=mode)
        table = distribute(inp["table"], mesh, m.pspecs(rules)["embed"]).requires_grad_(True)
        ids = distribute(inp["ids"], mesh, (rules["batch"], None))
        with sharding_rules(rules, mesh), CommDebugMode() as comm:
            rows = sharded_embed_lookup(table, ids, torch.bfloat16)
            h = m._embed(ids, params={"embed": table})  # then the residual's placements
            (h.float() * inp["probe"]).sum().backward()
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        with sharding_rules(rules, mesh), CommDebugMode() as naive:  # the trap
            table.detach().index_select(0, ids.reshape(-1))
        out[mode] = {
            "rows": rows.full_tensor(), "grad": table.grad.full_tensor(), "counts": counts,
            "naive_counts": {str(k): v for k, v in naive.get_comm_counts().items()},
            "grad_placements": str(tuple(table.grad.placements)),
            "table_placements": str(tuple(table.placements)),
            "rows_placements": str(tuple(rows.placements)),
            "local_rows": tuple(table.to_local().shape),
        }
    return out


def case_restore(inp):
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import store
    from repro_torch.models.common import distribute_tree, named_shardings
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.sharding.rules import make_rules

    m = LM(smoke_cut("codeqwen1.5-7b"))
    rules = make_rules(m.cfg, tp=4, mode="train")
    specs = m.pspecs(rules)
    params = distribute_tree(inp["params"], specs, _mesh())
    opt = init_state(params, OptConfig())
    for x in _leaves(opt["m"]):
        x.to_local().normal_(generator=torch.Generator().manual_seed(dist.get_rank()))
    tree = {"params": params, "opt": opt}
    want = _full_tree(tree)
    calls = {"host": 0, "full_tensor": 0}  # arrays built on this rank's host; gathers
    host, full = store._host, DTensor.full_tensor

    def spy_host(x):
        calls["host"] += 1
        return host(x)

    def spy_full(self, **kw):
        calls["full_tensor"] += 1
        return full(self, **kw)

    store._host, DTensor.full_tensor = spy_host, spy_full
    try:
        store.save(inp["dir"], 3, tree)
    finally:
        store._host = host
    out = {"saved": want, "leaves": len(_leaves(tree))}
    for shape in ((4, 2), (1, 8)):
        mesh = _mesh(shape)
        sh = {"params": named_shardings(specs, mesh),
              "opt": {k: named_shardings(() if k == "count" else specs, mesh) for k in opt}}
        DTensor.full_tensor = spy_full
        try:
            got, manifest = store.restore(inp["dir"], tree, shardings=sh)
        finally:
            DTensor.full_tensor = full
        same = all(torch.equal(a, b) for a, b in zip(_leaves(_full_tree(got)), _leaves(want)))
        local = {tuple(x.device_mesh.mesh.shape) for x in _leaves(got)}
        out[shape] = {"equal": same, "meshes": sorted(local), "step": manifest["step"],
                      "embed_local": tuple(got["params"]["embed"].to_local().shape)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, calls)
    out["calls"] = every
    return out


def case_resume(inp):
    """``Trainer`` on the (2, 4) mesh from its own seeded init for 2 steps,
    a checkpoint every step; then a new job on a (4, 2) mesh (tp 2) resumes
    from it (its restored optimizer state returned as read) and runs steps 2
    and 3."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.loop import LoopConfig, Trainer

    out = {}
    for shape, total in (((2, 4), 2), ((4, 2), 4)):
        mesh = _mesh(shape)
        m = LM(smoke_cut("codeqwen1.5-7b"))
        rules = make_rules(m.cfg, tp=shape[1], mode="train")
        t = Trainer(m, OptConfig(**inp["opt"]), DataConfig(**inp["data"]),
                    LoopConfig(total_steps=total, ckpt_dir=inp["dir"], ckpt_every=1,
                               log_every=1), device="cpu", mesh=mesh, rules=rules)
        params, state, start = t.init_or_resume()
        restored = _full_tree(state)  # before the steps update it in place
        params, state, history = t.run(params, state, start)
        out[shape] = {"history": history, "params": _full_tree(params), "restored": restored,
                      "state": _full_tree(state),
                      "meshes": sorted({tuple(x.device_mesh.mesh.shape) for x in _leaves(params)})}
    return out


def case_launch(inp):
    from repro_torch.launch import train as launch_train

    try:
        launch_train.main(["--arch", "codeqwen1.5-7b", "--smoke", "--distributed",
                           "--device", "cpu", "--steps", "1"])
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


class _Collectives:
    """Every collective the ops below it issue, as (kind, group name, output
    shape): the local ops DTensor runs, as ``cost_utils.CostCounter`` sees
    them."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if func.namespace == "_c10d_functional" and not func._opname.startswith(
                        ("wait", "_")):
                    group = next((a for a in reversed(args) if isinstance(a, str)), "")
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    seen.extend((func._opname, group, tuple(t.shape)) for t in outs
                                if isinstance(t, torch.Tensor))
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _groups(mesh) -> dict:
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


def case_family(inp):
    from repro_torch.checkpoint.store import full_tensor
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models.common import distribute, distribute_tree, sharding_rules
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.sharding.rules import attn_mode, make_rules
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.step import make_prefill, make_serve_step

    mesh = _mesh()
    cfg = inp["cfg"]
    groups = _groups(mesh)
    out = {"mode": attn_mode(cfg, 4), "groups": groups}
    if inp.get("train"):
        m = LM(cfg)
        rules = make_rules(cfg, tp=4, mode="train")
        # a replicated leaf's local tensor may be the given one: train a copy
        params = distribute_tree(_full_tree(inp["params"]), m.pspecs(rules), mesh)
        t = Trainer(m, OptConfig(**inp["opt"]), DataConfig(**inp["data"]),
                    LoopConfig(total_steps=inp["train"], log_every=1), device="cpu", mesh=mesh,
                    rules=rules)
        norms, step_fn = [], t.step_fn

        def spy(*a):
            res = step_fn(*a)
            norms.append(float(res[2]["grad_norm"]))
            return res

        t.step_fn = spy
        trained, state, history = t.run(params, init_state(params, t.opt_cfg), 0)
        out["train"] = {"params": _full_tree(trained), "history": history, "grad_norms": norms,
                        "state": _full_tree(state),
                        "placements": sorted({str(tuple(x.placements)) for x in _leaves(trained)})}
        dp = rules["batch"]
        batch = {k: distribute(v, mesh, (dp, "model" if k == "tokens" else None))
                 for k, v in inp["batch"].items()}
        with sharding_rules(rules, mesh), _Collectives() as coll:
            loss, _ = m.loss(batch)
            loss.backward()
        out["train"]["loss_collectives"] = coll.seen
        out["train"]["loss"] = float(full_tensor(loss))
    m = LM(cfg).load_params(inp["params"]).compress()
    prompt = inp["prompt"]
    plen = prompt["tokens"].shape[1]
    rules = make_rules(cfg, tp=4, mode="prefill")
    dp = rules["batch"]
    with _Collectives() as coll:
        m.distribute(mesh, rules)
    out["absorb_collectives"] = coll.seen
    batch = {k: distribute(v, mesh, (dp, "model") if k == "tokens" else (dp,))
             for k, v in prompt.items()}
    with sharding_rules(rules, mesh), _Collectives() as coll:
        logits, cache = make_prefill(m)(batch)
    out["prefill_collectives"] = coll.seen
    out["prefill"] = full_tensor(logits)
    full = pad_cache(_full_tree(cache), plen, inp["cap"])
    rules = make_rules(cfg, tp=4, mode="decode")
    m = LM(cfg).load_params(inp["params"]).compress()
    with _Collectives() as coll:
        m.distribute(mesh, rules)
    out["absorb_collectives"] += coll.seen
    cache = distribute_tree(full, m.cache_pspecs(rules), mesh)
    out["cache_placements"] = {str(k): str(tuple(v.placements)) for k, v in zip(
        *_paths(cache))}
    steps, colls = [], []
    step = make_serve_step(m)
    for i, tok in enumerate(inp["feed"]):
        with sharding_rules(rules, mesh), _Collectives() as coll:
            lg, cache = step(cache, {"tokens": distribute(tok, mesh, (rules["batch"],))}, plen + i)
        steps.append(full_tensor(lg))
        colls.append(coll.seen)
    out.update(steps=steps, step_collectives=colls, cache=_full_tree(cache))
    return out


def _paths(tree):
    from repro_torch.checkpoint.store import flatten

    leaves, paths = flatten(tree)
    return paths, leaves


def case_nll(inp):
    """``vocab_nll`` of ``inp["logits"]`` (B, S, C·V) against ``inp["labels"]``
    per layout ``(mesh shape, C, V)``: the logits split along the vocab over
    'model' and the batch over 'data'; the nll, the logits' gradient of the
    nll's sum weighted by ``inp["probe"]``, and the collectives."""
    from repro_torch.models.common import distribute, sharding_rules
    from repro_torch.models.model import vocab_nll

    out = {}
    for shape, books, vocab in inp["layouts"]:
        mesh = _mesh(shape)
        n = books * vocab
        lg = distribute(inp["logits"][..., :n].clone(), mesh, ("data", None, "model"))
        lg.requires_grad_(True)
        labels = distribute(inp["labels"][..., :books] % vocab, mesh, ("data", None, None))
        probe = distribute(inp["probe"][..., :books], mesh, ("data", None, None))
        with sharding_rules({"batch": ("data",), "vocab": "model"}, mesh), \
                _Collectives() as coll:
            nll = vocab_nll(lg, labels, books, vocab)
            (nll * probe).sum().backward()
        out[(shape, books, vocab)] = {"nll": nll.full_tensor(), "grad": lg.grad.full_tensor(),
                                      "collectives": coll.seen,
                                      "local": tuple(lg.to_local().shape)}
    return out


CASES = {k.removeprefix("case_"): v for k, v in globals().items() if k.startswith("case_")}


def _rank(rank: int, n: int, case: str, work: str):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = torch.load(Path(work) / "input.pt", weights_only=False)
        out = CASES[case](inp)
        if rank == 0:
            torch.save(out, Path(work) / "result.pt")
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(argv):
    import warnings

    import torch.multiprocessing as mp

    warnings.filterwarnings("ignore")
    case, work, n = argv[0], argv[1], int(argv[2])
    mp.spawn(_rank, args=(n, case, work), nprocs=n)


if __name__ == "__main__":
    main(sys.argv[1:])
