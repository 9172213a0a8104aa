"""The port's distribution on an 8-rank gloo world on the CPU, a (2, 4)
("data", "model") mesh, the reference's own test mesh
(``tests/test_distributed.py``).

Each test runs one world in a subprocess (``tests/torch_dist_world.py``):
the sharded step there is held against the port's single-device step here,
and that one against the reference's single-device step here too. (The
reference's own sharded twins are red under jax 0.9.0, so they cannot be the
yardstick.) Checks:

  - the sharded train step (``Trainer`` on a mesh, the launcher's path, 2
    steps) for ``codeqwen1.5-7b`` and ``internvl2-2b`` at the reference
    test's cut: the loss within 5e-3, every parameter within 5e-3 and the
    global gradient norm within 2e-2 relative of the port's single-device
    run, and its optimizer state by ``check_state`` (the step count, each
    leaf's Adam moments, the fp32 master's update); that run's loss within 2e-3 relative (``tests/test_torch_loss.py``'s
    bf16 bound) and its parameters within 5e-3 of the reference's;
  - the ``qwen2-72b`` smoke decode step on compressed weights: logits within
    5e-2 (the reference test's bf16 bound) of the single-device step, every
    compressed projection run by the tc kernel's plain version on local
    shards (14 calls a rank, no DTensor reaching it), nothing densified and
    no product but the dense head's, on the rank's vocab shard;
  - ``LM.constrain`` on shards split along N: the same patterns as on one
    device (the count of differing entries is reported, and 0);
  - the embedding table staying sharded: no all-gather under
    ``CommDebugMode``, forward or backward, where a lookup by the table's
    own DTensor ops all-gathers it;
  - ``restore(shardings=)`` of a (2, 4) checkpoint onto (4, 2) and (1, 8),
    bit for bit (the twin of
    ``tests/test_substrate.py::TestCheckpoint::test_elastic_reshard_on_load``),
    only rank 0 building the arrays written; ``Trainer`` resuming a (2, 4)
    run on a (4, 2) mesh, its restored optimizer state checked;
  - ``launch.train --distributed`` in a world that is not 256 ranks raising
    and naming the sizes;
  - the q-sharded and the context-parallel attention mode (qwen2-72b's cut,
    starcoder2-7b's with 6 heads): the sharded ``Trainer`` under the train
    step's gates, and prefill plus two compressed decode steps within 5e-2,
    the context decode's cache split along its sequence and no collective
    moving keys or values.

Values measured by this file: see each test's docstring. The file takes
about 240 s alone on 8 cores (12 worlds, each about 8 s of start-up).
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.checkpoint import store as jstore
from repro.configs import make_batch as jmake_batch
from repro.configs import smoke_config as jsmoke
from repro.data.pipeline import DataConfig as JData
from repro.models.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.train.loop import LoopConfig as JLoop
from repro.train.loop import Trainer as JTrainer
from repro.train.step import make_serve_step as jmake_serve_step
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models.common import dbb_leaves, sharded_embed_lookup, tree_get
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.step import make_serve_step

pytestmark = pytest.mark.slow  # an 8-process world a test, as the reference's twin

REPO = pathlib.Path(__file__).resolve().parents[1]
CUT = dict(d_model=64, d_ff=128, vocab_size=512, num_layers=2)  # the reference test's
OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)  # lr > 0 from step 0
DATA = dict(seq_len=32, global_batch=4)
# a sharded run's optimizer state against the single-device run's
# (``check_state``): measured within 1.9e-2 (moments) and 8.1e-2 (update)
MOMENT_GAP = 5e-2
UPDATE_GAP = 0.25


class world:
    """``case`` on an ``n``-rank gloo world in a subprocess, started at once
    so that the parent computes its side meanwhile; :meth:`result` waits
    (at most 300 s) and returns rank 0's result."""

    def __init__(self, case: str, work: pathlib.Path, inp: dict, n: int = 8):
        torch.save(inp, work / "input.pt")
        self.work = work
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dist_world.py"), case, str(work),
             str(n)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    def result(self) -> dict:
        try:
            out, err = self.proc.communicate(timeout=300)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.communicate()
        assert self.proc.returncode == 0, f"STDOUT:\n{out[-3000:]}\nSTDERR:\n{err[-6000:]}"
        return torch.load(self.work / "result.pt", weights_only=False)


def reference(arch: str, constrain: bool = True):
    """The reference's model at the cut and its seeded parameters, and the
    port's model holding the same ones."""
    jm = JLM(dataclasses.replace(jsmoke(arch), **CUT))
    jp = jm.init(jax.random.PRNGKey(0))
    if constrain:
        jp = jm.constrain(jp)
    tm = LM(dataclasses.replace(smoke_config(arch), **CUT))
    tm.load_params(params_from_numpy(tp.to_numpy(jp), "cpu"))
    return jm, jp, tm


def leaves(tree):
    return [x.detach().float() for x in store.flatten(tree)[0]]


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(leaves(a), leaves(b)))


def clone(tree):
    return store.unflatten(tree, [x.detach().clone() for x in store.flatten(tree)[0]])


def norm(xs) -> float:
    return math.sqrt(sum(float(x.double().square().sum()) for x in xs))


def check_state(got, want, p0, steps: int, params=None) -> dict:
    """A sharded run's optimizer state against the single-device one's from
    the same parameters ``p0``, in fp32: the step count equal; ``m`` and
    ``v`` leaf by leaf within ``MOMENT_GAP`` of the single-device ones,
    relative to their size (2-norms); and the update the fp32 master took
    (``master - p0``) within ``UPDATE_GAP`` relative over the whole tree.
    (Leaf by leaf an update can differ by its own size: Adam's first steps
    move an entry by about lr whatever its gradient, so where a gradient is
    rounding noise, as the key bias's is (softmax ignores a constant added
    to every score), its sign is too.) An fp32 model keeps no master: its
    update is that of the parameters, ``params`` = (sharded, single-device).
    Returns the largest gaps."""
    assert int(got["count"]) == int(want["count"]) == steps, (got["count"], want["count"])
    worst = {}
    for key in ("m", "v"):
        # a leaf whose gradient is zero on one device (a parameter the forward
        # does not read) must be zero sharded too
        g = {path: norm([a - b]) / norm([b]) if norm([b]) else (math.inf if norm([a]) else 0.0)
             for path, a, b in
             zip(store.flatten(want[key])[1], leaves(got[key]), leaves(want[key]))}
        path = max(g, key=g.get)
        worst[key] = (g[path], path)
        assert g[path] <= MOMENT_GAP, (key, path, g[path])
    start = leaves(p0)
    have, ref = (got["master"], want["master"]) if params is None else params
    moved = [b - c for b, c in zip(leaves(ref), start)]
    worst["update"] = norm([a - b for a, b in zip(leaves(have), leaves(ref))]) / norm(moved)
    assert worst["update"] <= UPDATE_GAP, worst
    return worst


def run_port(tm, params, total: int = 2, start: int = 0, state=None, opt=OPT):
    """The port's single-device ``Trainer`` from ``params`` (and ``state``
    at step ``start``) to step ``total``: (params, state, losses, grad
    norms)."""
    t = Trainer(tm, adamw.OptConfig(**opt), DataConfig(**DATA),
                LoopConfig(total_steps=total, log_every=1), device="cpu")
    norms, step_fn = [], t.step_fn

    def spy(*a):
        out = step_fn(*a)
        norms.append(float(out[2]["grad_norm"]))
        return out

    t.step_fn = spy
    if state is None:
        state = adamw.init_state(params, t.opt_cfg)
    out, state, history = t.run(params, state, start)
    return out, state, [loss for _, loss in history], norms


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "internvl2-2b"])
def test_sharded_train_step_matches_single_device(arch, tmp_path):
    """Measured, codeqwen1.5-7b: the sharded losses 1.3e-3 and 2.7e-3 from
    the single-device ones, parameters within 3.9e-3 (one bf16 ulp below
    1.0: a norm gain that one run steps down and the other up, where its
    gradient is at the level of rounding), gradient norms within 2.0e-3
    relative; the single-device losses within 6.7e-5 relative of the
    reference's, parameters within 3.8e-3; the state's moments within
    1.9e-2, its update 8.1e-2. internvl2-2b: 8.7e-5 and 1.7e-3, 3.9e-3,
    4.9e-4; 3.1e-4, 3.9e-3; 1.5e-2, 6.1e-2."""
    jm, jp, tm = reference(arch)
    run = world("train", tmp_path, {"arch": arch, "params": tm.params, "opt": OPT,
                                    "data": DATA, "steps": 2})

    jt = JTrainer(jm, jadamw.OptConfig(**OPT), JData(**DATA), JLoop(total_steps=2, log_every=1))
    jout, _, jhist = jt.run(jp, jadamw.init_state(jp, jt.opt_cfg), 0)
    p0 = clone(tm.params)
    out, state, losses, norms = run_port(tm, tm.params)
    got = run.result()

    jlosses = [loss for _, loss in jhist]
    for a, b in zip(losses, jlosses):  # the port on one device against the reference
        assert abs(a - b) <= 2e-3 * abs(b), (losses, jlosses)
    jtree = params_from_numpy(tp.to_numpy(jout), "cpu")
    assert max_diff(out, jtree) <= 5e-3

    sharded = [loss for _, loss in got["history"]]
    assert len(sharded) == 2
    worst = check_state(got["state"], state, p0, steps=2)
    for a, b in zip(sharded, losses):  # sharded against one device
        assert abs(a - b) <= 5e-3, (sharded, losses)
    for a, b in zip(got["grad_norms"], norms):
        assert abs(a - b) <= 2e-2 * b, (got["grad_norms"], norms)
    d = max_diff(got["params"], out)
    assert d <= 5e-3, d
    assert any("Shard" in p for p in got["placements"])  # the update ran on shards
    print(arch, "losses", sharded, losses, jlosses, "norms", got["grad_norms"], norms,
          "param diff sharded/single", d, "single/reference", max_diff(out, jtree),
          "state gaps", worst)


def test_sharded_decode_matches_single_device(tmp_path):
    """Measured: the sharded logits within 3.9e-2 of the single-device ones
    (bf16 sums in another order), and those within 3.7e-2 of the
    reference's."""
    jcfg = jsmoke("qwen2-72b")
    jm = JLM(jcfg)
    jp = jm.constrain(jm.init(jax.random.PRNGKey(0)))
    jbatch = jmake_batch(jcfg, batch=4, seq=1, kind="serve")
    tcfg = smoke_config("qwen2-72b")
    dense = params_from_numpy(tp.to_numpy(jp), "cpu")
    tokens = torch.as_tensor(np.array(jbatch["tokens"])).long()
    run = world("decode", tmp_path, {"cfg": tcfg, "params": dense, "tokens": tokens, "pos": 7,
                                     "cache": (4, 32)})
    lg_ref, _ = jax.jit(jmake_serve_step(jm))(jm.compress(jp), jm.init_cache(4, 32), jbatch,
                                              jnp.int32(7))
    tm = LM(tcfg).load_params(dense).compress()
    lg, _ = make_serve_step(tm)(tm.init_cache(4, 32), {"tokens": tokens}, 7)
    d_ref = float((lg.float() - torch.as_tensor(np.asarray(lg_ref, np.float32))).abs().max())
    assert d_ref < 5e-2, d_ref

    got = run.result()
    d = float((got["logits"].float() - lg.float()).abs().max())
    assert d < 5e-2, d
    # every compressed projection reached the kernel's plain version on local
    # shards: 2 layers x (wq, wk, wv, wo, w_gate, w_up, w_down) on each rank
    calls = got["calls"]
    assert len(calls) == 2 * 7 and not any(dt for _, _, dt in calls), calls
    dm, ff, hd = tcfg.d_model, tcfg.d_ff, tcfg.hd
    nb = lambda k: k // tcfg.dbb.bz  # noqa: E731
    nnz = tcfg.dbb.nnz
    expected = {  # (local A, local values): column-parallel N / 4, row-parallel K / 4
        ((2, dm), (nb(dm), nnz, tcfg.num_heads * hd // 4)),  # wq (heads on model)
        ((2, dm), (nb(dm), nnz, tcfg.num_kv_heads * hd)),  # wk, wv (kv replicated)
        ((2, tcfg.num_heads * hd // 4), (nb(tcfg.num_heads * hd) // 4, nnz, dm)),  # wo
        ((2, dm), (nb(dm), nnz, ff // 4)),  # w_gate, w_up
        ((2, ff // 4), (nb(ff) // 4, nnz, dm)),  # w_down
    }
    assert {(a, v) for a, v, _ in calls} == expected, calls
    assert got["densified"] == 0
    # the dense head, on each rank's vocab shard (its columns over 'model')
    assert got["products"] == [(dm, tcfg.padded_vocab // 4)], got["products"]
    print("decode: logits sharded/single", d, "single/reference", d_ref)


def test_constrain_picks_the_same_patterns_across_model_shards(tmp_path):
    """A block's score sums |w| over all N columns, which the mesh splits
    over 'model' (and K over 'data'): the partial scores are summed across
    ranks before the top-k. Measured: 0 entries of the patterns differ, over
    every DBB leaf."""
    jm, jp, tm = reference("codeqwen1.5-7b", constrain=False)
    run = world("constrain", tmp_path, {"arch": "codeqwen1.5-7b", "params": tm.params})
    tm.constrain()
    want = params_from_numpy(tp.to_numpy(jm.constrain(jp)), "cpu")
    got = run.result()
    differ = total = 0
    for path, _ in dbb_leaves(tm.defs()):
        a, b = tree_get(got["params"], path), tree_get(tm.params, path)
        assert torch.equal(tree_get(want, path), b)  # one device: the reference's bits
        differ += int(((a != 0) != (b != 0)).sum())
        total += b.numel()
        assert torch.equal(a, b), path
    print(f"constrain across shards: {differ} of {total} pattern entries differ")
    assert differ == 0


def test_embedding_table_stays_sharded(tmp_path):
    """No all-gather, forward or backward, under train (the residual
    reduce-scattered along seq) and decode rules; the rows equal the plain
    lookup bit for bit (one shard holds each row, the others add zeros) and
    the table's gradient is its plain one within 1 bf16 ulp of its largest
    entry (measured: 1.6e-2 under both rules, one ulp of an entry between 2
    and 4: each data shard's part of a row's gradient is rounded to bf16
    before the parts are summed)."""
    g = torch.Generator().manual_seed(0)
    table = (0.02 * torch.randn(512, 64, generator=g)).to(torch.bfloat16)
    ids = torch.randint(0, 512, (4, 32), generator=g)
    probe = torch.randn(4, 32, 64, generator=g)
    run = world("embed", tmp_path, {"table": table, "ids": ids, "probe": probe})
    tab = table.clone().requires_grad_(True)
    rows = sharded_embed_lookup(tab, ids, torch.bfloat16)
    (rows.float() * probe).sum().backward()
    got = run.result()
    diffs = {}
    for mode, r in got.items():
        gathers = {k: v for k, v in r["counts"].items() if "all_gather" in k}
        assert gathers == {}, (mode, r["counts"])
        assert any("all_gather" in k for k in r["naive_counts"]), (mode, r["naive_counts"])
        # vocab split over 'model', the gradient too (its sum over the data
        # shards pending until the update)
        assert r["table_placements"] == "(Replicate(), Shard(dim=0))", r
        assert r["grad_placements"] == "(Partial(sum), Shard(dim=0))", r
        assert r["local_rows"] == (128, 64)
        assert torch.equal(r["rows"], rows.detach())
        ulp = float(tab.grad.abs().max()) * 2 ** -7
        diffs[mode] = float((r["grad"].float() - tab.grad.float()).abs().max())
        assert diffs[mode] <= ulp, mode
    print({m: r["counts"] for m, r in got.items()}, "grad diffs", diffs)


def test_restore_reshards_onto_other_meshes(tmp_path):
    """The twin of ``test_elastic_reshard_on_load``: a (2, 4) training state
    saved as logical arrays restores onto (4, 2) and (1, 8) meshes bit for
    bit, and unsharded into either package. Only rank 0 builds the arrays
    written, one per leaf, and neither the save nor the restores gather a
    whole leaf onto any rank's device (no ``full_tensor``)."""
    _, jp, tm = reference("codeqwen1.5-7b")
    ckpt = tmp_path / "ckpt"
    got = world("restore", tmp_path, {"params": tm.params, "dir": str(ckpt)}).result()
    assert got["calls"] == [{"host": got["leaves"], "full_tensor": 0}] + \
        [{"host": 0, "full_tensor": 0}] * 7, got["calls"]
    for shape in ((4, 2), (1, 8)):
        r = got[shape]
        assert r["equal"] and r["step"] == 3 and r["meshes"] == [shape], r
        assert r["embed_local"] == (512 // shape[1], 64)  # vocab over 'model'
    saved = got["saved"]
    plain, _ = store.restore(ckpt, saved)
    assert all(torch.equal(a, b) for a, b in zip(store.flatten(plain)[0],
                                                 store.flatten(saved)[0]))
    assert torch.equal(saved["params"]["embed"], tm.params["embed"])
    like = {"params": jp, "opt": jadamw.init_state(jp, jadamw.OptConfig())}
    jtree, _ = jstore.restore(ckpt, like)  # the reference reads it too
    jleaves = jax.tree_util.tree_leaves(jtree)
    assert len(jleaves) == len(store.flatten(saved)[0])
    for a, b in zip(jleaves, store.flatten(saved)[0]):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_trainer_resumes_onto_another_mesh(tmp_path):
    """The launcher's path end to end: ``Trainer`` on a (2, 4) mesh draws
    its parameters leaf by leaf onto the mesh, constrains them there and
    checkpoints every step; a new job on a (4, 2) mesh resumes from step 1
    and runs steps 2 and 3. Held against 4 steps of the single-device
    ``Trainer`` from the same seed: the restored optimizer state (count,
    the master's update, ``m``, ``v``) against the single-device state after
    step 1, and the final state after step 3, by ``check_state``; losses
    within 5e-3, parameters within 5e-3. The learning rate is 1e-4, a tenth
    of the other tests': the absolute parameter bound is for bf16 rounding,
    and three Adam steps whose sign is rounding noise in one run may each
    differ by 2 lr, which at 1e-3 with one bf16 ulp below 1.0 (a norm gain)
    passes 5e-3 (5.3e-3 measured); the relative state checks do not depend
    on it. Measured at 1e-4: losses within 1.3e-3, parameters 9.8e-4; the
    state as restored within 1.8e-2 (moments) and 7.1e-2 (update), after
    step 3 within 1.3e-2 and 5.0e-2."""
    opt = dict(OPT, peak_lr=1e-4)
    run = world("resume", tmp_path, {"opt": opt, "data": DATA, "dir": str(tmp_path / "ckpt")})
    tm = LM(dataclasses.replace(smoke_config("codeqwen1.5-7b"), **CUT))
    p0 = clone(tm.init(torch.Generator("cpu").manual_seed(0), "cpu").constrain().params)
    t = Trainer(tm, adamw.OptConfig(**opt), DataConfig(**DATA),
                LoopConfig(total_steps=2, log_every=1), device="cpu")
    params, state, history = t.run()  # the same seeded init
    at1 = clone(state)
    params, state, later, _ = run_port(tm, params, total=4, start=2, state=state, opt=opt)
    got = run.result()
    first, resumed = got[(2, 4)], got[(4, 2)]
    assert [s for s, _ in first["history"]] == [0, 1]
    assert [s for s, _ in resumed["history"]] == [2, 3]
    assert resumed["meshes"] == [(4, 2)]
    gap1 = check_state(resumed["restored"], at1, p0, steps=2)  # what the resume read
    gap3 = check_state(resumed["state"], state, p0, steps=4)
    losses = dict(first["history"] + resumed["history"])
    want = [loss for _, loss in history] + later
    diffs = [abs(losses[s] - loss) for s, loss in enumerate(want)]
    assert max(diffs) <= 5e-3, (losses, want)
    d = max_diff(resumed["params"], params)
    assert d <= 5e-3, d
    print("resume: loss diffs", diffs, "param diff", d, "state gaps at step 1", gap1,
          "at step 3", gap3)


def test_distributed_launch_names_the_world_it_needs(tmp_path):
    got = world("launch", tmp_path, {}, n=2).result()
    msg = got["error"]
    assert msg and "256" in msg and "512" in msg and "has 2" in msg, msg


# the attention modes at tp 4 (sharding/rules.py:attn_mode): qwen2-72b's
# smoke cut (4 heads, 1 kv head) is q-sharded; starcoder2-7b's with 6 heads
# and 2 kv heads is context-parallel (neither divides 4)
MODES = {"q_sharded": ("qwen2-72b", {}),
         "context": ("starcoder2-7b", dict(num_heads=6, num_kv_heads=2))}


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_modes_train_step_matches_single_device(mode, tmp_path):
    """The sharded ``Trainer`` (2 steps, tokens split along the sequence on
    'model' as the reference's dryrun feeds them) in the q-sharded and the
    context-parallel mode against the port's single-device run, with
    ``test_sharded_train_step_matches_single_device``'s gates: losses within
    5e-3, every parameter within 5e-3, gradient norms within 2e-2
    relative, the optimizer state by ``check_state``."""
    from repro_torch.sharding.rules import attn_mode

    arch, extra = MODES[mode]
    tm = LM(dataclasses.replace(smoke_config(arch), **CUT, **extra))
    assert attn_mode(tm.cfg, 4) == mode
    tm.init(torch.Generator("cpu").manual_seed(0), "cpu").constrain()
    run = world("train", tmp_path, {"arch": arch, "extra": extra, "params": tm.params,
                                    "opt": OPT, "data": DATA, "steps": 2})
    p0 = clone(tm.params)
    out, state, losses, norms = run_port(tm, clone(tm.params))
    got = run.result()
    sharded = [loss for _, loss in got["history"]]
    assert len(sharded) == 2
    worst = check_state(got["state"], state, p0, steps=2)
    for a, b in zip(sharded, losses):
        assert abs(a - b) <= 5e-3, (sharded, losses)
    for a, b in zip(got["grad_norms"], norms):
        assert abs(a - b) <= 2e-2 * b, (got["grad_norms"], norms)
    d = max_diff(got["params"], out)
    assert d <= 5e-3, d
    assert any("Shard" in p for p in got["placements"])
    print(mode, "losses", sharded, losses, "norms", got["grad_norms"], norms, "param diff", d,
          "state gaps", worst)


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_modes_serve_matches_single_device(mode, tmp_path):
    """Prefill (tokens split along the sequence) and two compressed decode
    steps in the q-sharded and the context-parallel mode against the port's
    single-device steps: logits within 5e-2 (the reference test's bf16
    bound) at the prefill's last position and at each step, and the cache
    after them within 5e-2. In the context mode the decode cache is split
    along its sequence over 'model' (8 of 32 slots a rank), each step runs
    the combine's all-reduces, and no decode collective moves keys or values
    of more than one position (no cache slice is gathered); in the q-sharded
    mode the cache is replicated over 'model'."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.train.step import make_prefill

    arch, extra = MODES[mode]
    cfg = dataclasses.replace(smoke_config(arch), **CUT, **extra)
    dense = LM(cfg).init(torch.Generator("cpu").manual_seed(0), "cpu").constrain().params
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
    cap = 32
    run = world("serve", tmp_path, {"cfg": cfg, "params": dense, "prompt": prompt, "cap": cap})
    tm = LM(cfg).load_params(clone(dense)).compress()
    logits, cache = make_prefill(tm)({"tokens": prompt})
    cache = pad_cache(cache, 16, cap)
    steps, tok = [], logits[:, -1:].argmax(-1)
    for i in range(2):
        lg, cache = make_serve_step(tm)(cache, {"tokens": tok}, 16 + i)
        steps.append(lg)
        tok = lg[:, -1:].argmax(-1)
    got = run.result()
    assert got["mode"] == mode
    diffs = [float((got["prefill"].float() - logits.float()).abs().max())]
    diffs += [float((a.float() - b.float()).abs().max()) for a, b in zip(got["steps"], steps)]
    assert max(diffs) < 5e-2, diffs
    d_cache = max_diff(got["cache"], cache)
    assert d_cache < 5e-2, d_cache
    if mode == "context":
        assert got["cache_placements"] == "(Shard(dim=1), Shard(dim=2))", got["cache_placements"]
        assert got["cache_local"] == (cfg.num_layers, 2, cap // 4, cfg.num_kv_heads, cfg.hd)
        for c in got["collectives"]:  # the combine's three all-reduces a layer, no K/V
            assert c["counts"]["all-reduce"] >= 3 * cfg.num_layers
            kv = [s for _, s in c["shapes"] if s[-2:] == (cfg.num_kv_heads, cfg.hd) and s[-3] > 1]
            assert not kv, kv
    else:
        assert got["cache_placements"] == "(Shard(dim=1), Replicate())", got["cache_placements"]
    print(mode, "logit diffs", diffs, "cache diff", d_cache, "collectives", got["collectives"])
