"""The port's training path held against the JAX reference on the CPU:
``PruneSchedule``, ``LM.constrain``, the loss's gradients, AdamW, the token pipeline, ``train_step``, ``Trainer`` (auto-
resume, preemption) and the launcher; and the checkpoint of a port-trained
``(params, opt_state)`` read by the reference's store.

Parameters come from the reference (``torch_parity.to_numpy`` ->
``interop.params_from_numpy``); batches from both packages' pipelines,
which are numpy and equal. The tight comparisons use an fp32 copy of the
model (``param_dtype`` and ``compute_dtype`` float32), ``small_model``:
``smoke_config("codeqwen1.5-7b")`` at 2 layers, d_model 64, d_ff 128,
vocab 256, as ``tests/test_substrate.py`` cuts it.

Tolerances, each with the value this file measured beside it:
  - ``nnz_at``, the annealed ``constrain`` (internvl2's smoke config from
    the reference's init, its bf16 and fp32 leaves), the batches, remat 'full' and 'dots' against 'none', the
    kill-resume twin, the checkpoint read back: equal (0 differences);
  - the fp32 loss within 1e-5 relative (8e-8 measured; every family's in
    ``tests/test_torch_loss.py``);
  - gradients within rtol 1e-4, atol 1e-6 (7 % of the bound);
  - ``apply_updates`` from identical gradients: every fp32 leaf of the
    parameters and the state within 1e-6 of the leaf's largest magnitude
    (3.7e-9 against 1e-2 measured: XLA contracts ``b1 * m + (1 - b1) * g``
    into one rounding where torch rounds twice, which shows where the two
    terms cancel; its ``pow`` and ``cos`` round apart by an ulp), a bf16
    parameter within one bf16 ulp of the reference's (it is the rounding of
    that master), the error-feedback residual within one int8 code's
    step;
  - one ``train_step`` and 6 steps within the reference's kill-resume
    tolerance, rtol 2e-4, atol 2e-5: one step every entry (88 % of the
    bound at worst), 6 steps every entry but 2. Adam's step is about
    ``g / |g|``, so where ``g`` is at the level of rounding its sign is
    noise in both packages and the step is ``±lr``. The 2 entries are of
    the key bias ``bk`` along the RoPE dimensions of the lowest
    frequencies, where a bias is nearly a shift shared by every key and
    softmax ignores it (``|g|`` 7.5e-8 there against 4e-3 at the highest);
    at most 1.94 times the bound. An entry beyond the bound must have a
    first gradient below 1e-6, the gradients' own atol (144 entries do),
    and must have moved in each package no further than AdamW's reach over
    those steps (``adamw.reach``); their count is reported.
    ``test_apply_updates_from_identical_gradients`` holds every entry of
    the update tightly, these included, once the gradients are the same.
No DBB block flipped its kept set between the packages in these runs: a
flip would be counted and reported by ``_flips``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.checkpoint import store as jstore
from repro.configs import smoke_config as jsmoke
from repro.core.sparse_linear import PruneSchedule as JSchedule
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.models.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.train.loop import LoopConfig as JLoop
from repro.train.loop import Trainer as JTrainer
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.core.sparse_linear import PruneSchedule
from repro_torch.core.vdbb import DBBFormat, satisfies_dbb
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.common import dbb_leaves, tree_get
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.step import make_train_step, to_device

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256)
F32 = (dict(param_dtype=jnp.float32, compute_dtype=jnp.float32),
       dict(param_dtype=torch.float32, compute_dtype=torch.float32))


def small_models(fp32=True, **over):
    """The reference's and the port's ``small_model`` (fp32 copies unless
    ``fp32=False``)."""
    jo, to = F32 if fp32 else ({}, {})
    jm = JLM(dataclasses.replace(jsmoke("codeqwen1.5-7b"), **SMALL, **jo, **over))
    tm = LM(dataclasses.replace(smoke_config("codeqwen1.5-7b"), **SMALL, **to, **over))
    return jm, tm


def load_reference_params(jm, tm, seed=0, constrain=True):
    """The reference's seeded (and constrained) parameters, in both."""
    jp = jm.init(jax.random.PRNGKey(seed))
    if constrain:
        jp = jm.constrain(jp)
    tm.load_params(params_from_numpy(tp.to_numpy(jp), "cpu"))
    return jp


def leaves_np(tree):
    return [np.asarray(jnp.asarray(x).astype(jnp.float32)) if isinstance(x, jnp.ndarray)
            else x.detach().float().numpy() for x in
            (jax.tree_util.tree_leaves(tree) if not isinstance(tree, list) else tree)]


def port_leaves(tree):
    return store.flatten(tree)[0]


def matrices(w):
    """A DBB leaf's (K, N) matrices: a stacked leaf slice by slice."""
    return w.detach().reshape(-1, *w.shape[-2:])


def leaf_names(jtree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flips(jtree, ttree, names):
    """Blocks whose kept set differs between the packages (a near tie of two
    magnitudes after an update can flip one), per DBB leaf."""
    out = {}
    for name, a, b in zip(names, leaves_np(jtree), leaves_np(port_leaves(ttree))):
        n = int(((a == 0) != (b == 0)).sum())
        if n:
            out[name] = n
    return out


NOISE = 1e-6  # a gradient below the gradients' atol: its Adam step's sign is noise


def noise_entries(tm, batch) -> list:
    """Per leaf, the entries whose gradient at the port's current parameters
    is nonzero and below :data:`NOISE` (computed on a copy of the tree). An
    exact zero is structural and the same in both packages: an embedding
    row no token reads, or the columns of ``wv`` / ``w_up`` / ``w_gate``
    whose output features the next projection's shared pattern prunes
    away."""
    saved = tm.params
    tm.load_params(store.unflatten(saved, [p.detach().clone() for p in port_leaves(saved)]))
    try:
        _, grads = grads_of(tm, batch)
    finally:
        tm.load_params(saved)
    return [(g != 0).numpy() & (g.abs().numpy() < NOISE) for g in grads]


def assert_trees_close(jtree, ttree, *, rtol, atol, noise=None, start=None, lrs=(), opt=None):
    """Every leaf within (rtol, atol), and no DBB kept set different. An
    entry beyond (rtol, atol) must be a ``noise`` entry (a bool array a
    leaf) that moved, in each package, no further from its value in
    ``start`` (leaves as numpy) than AdamW can move any parameter in ``len(lrs)`` updates
    (``adamw.reach``, plus 1e-7 for fp32 rounding). Returns the worst ratio
    of a difference to (rtol, atol), the held entries left out, and the
    count of entries held to the reach instead."""
    names = leaf_names(jtree)
    assert port_leaves(ttree) and len(names) == len(port_leaves(ttree))
    flips = _flips(jtree, ttree, names)
    assert not flips, f"DBB kept sets differ (near ties after an update): {flips}"
    noise = noise or [None] * len(names)
    start = start or [None] * len(names)
    worst, n_reach = 0.0, 0
    for name, a, b, nz, a0 in zip(names, leaves_np(jtree), leaves_np(port_leaves(ttree)),
                                  noise, start):
        ratio = np.abs(a - b) / (atol + rtol * np.abs(a))
        beyond = ratio > 1.0
        if beyond.any():
            assert nz is not None and not (beyond & ~nz).any(), (name, float(ratio.max()))
            lim = adamw.reach(lrs, a0[beyond], opt) + 1e-7
            for got in (a, b):
                assert (np.abs(got[beyond] - a0[beyond]) <= lim).all(), (name, "beyond reach")
            n_reach += int(beyond.sum())
            ratio = np.where(beyond, 0.0, ratio)
        worst = max(worst, float(ratio.max()))
    return worst, n_reach


# ------------------------------------------------------------ PruneSchedule


SCHEDULES = [((0, 10), 3), ((0, 4), 2), ((5, 15), 3), ((0, 100), 2), ((3, 3), 3), ((0, 6), 1)]


@pytest.mark.parametrize("span,nnz", SCHEDULES)
def test_nnz_at_every_step_matches_the_references(span, nnz):
    """Every step of schedules whose anneal lands on half-way points (8 -
    s/2, 8 - 1.5 s, …): float32, rounded half to even, as the reference's
    traced step (``jnp.int32``) and its Python-int step compute it."""
    js, ts = JSchedule(*span), PruneSchedule(*span)
    jf, tf = jax_fmt(nnz), DBBFormat(8, nnz, "matrix")
    for step in range(span[1] + 3):
        got = ts.nnz_at(step, tf)
        assert isinstance(got, int)
        assert got == int(js.nnz_at(jnp.int32(step), jf)) == int(js.nnz_at(step, jf)), step


def jax_fmt(nnz):
    from repro.core.vdbb import DBBFormat as JFormat

    return JFormat(8, nnz, "matrix")


# --------------------------------------------------------------- constrain


@pytest.mark.parametrize("step", [None, 0, 25, 37, 50, 75, 100])
def test_annealed_constrain_matches_bit_for_bit(step):
    """``tests/test_system.py``'s anneal on internvl2-2b's smoke config (bf16,
    sparsity 0.75, stacked leaves): every leaf equal after ``constrain(step,
    PruneSchedule(0, 100))`` (``None``: the target bound)."""
    jcfg = jsmoke("internvl2-2b", sparsity=0.75)
    jm, tm = JLM(jcfg), LM(smoke_config("internvl2-2b", sparsity=0.75))
    jp = jax.tree_util.tree_map(
        lambda x: jnp.abs(x) + 0.01 if x.ndim >= 2 and x.dtype != jnp.int32 else x,
        jm.init(jax.random.PRNGKey(0)))
    tm.load_params(params_from_numpy(tp.to_numpy(jp), "cpu"))
    sched = None if step is None else JSchedule(0, 100)
    want = jm.constrain(jp, step, sched)
    tm.constrain(step, None if step is None else PruneSchedule(0, 100))
    for name, a, b in zip(leaf_names(want), jax.tree_util.tree_leaves(want),
                          port_leaves(tm.params)):
        assert same_bits(a, b), name


def same_bits(a, b) -> bool:
    """A reference array and a port tensor hold the same dtype and bits."""
    a, b = np.asarray(a), b.detach()
    if b.dtype == torch.bfloat16:
        return a.dtype == jnp.bfloat16 and np.array_equal(
            a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16))
    return a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def test_constrain_skips_compressed_leaves_and_keeps_tensors():
    _, tm = small_models()
    tm.init(torch.Generator().manual_seed(0), "cpu")
    wq = tm.params["layers"]["b0"]["mixer"]["wq"]
    tm.constrain()
    assert tm.params["layers"]["b0"]["mixer"]["wq"] is wq  # projected in place
    for path, pdef in dbb_leaves(tm.defs()):
        for sl in matrices(tree_get(tm.params, path)):
            assert satisfies_dbb(sl, pdef.dbb), path
    tm.compress()
    tm.constrain(3, PruneSchedule(0, 10))  # compressed leaves are left alone


# ----------------------------------------------------------------- pruning


@pytest.mark.parametrize("step", [None, 1, 5, 10])
def test_pruning_utilities_match_the_reference(step):
    """``core/pruning.py`` on sparse-cnn-tiny's smoke layers, made dense
    first so the anneal shows: ``make_constrain_fn`` (the port projects its
    layers in place, the reference threads sub-trees) at each step of
    ``PruneSchedule(0, 10)``, ``global_dbb_stats`` and
    ``prune_tree_to_dbb``, equal to the reference's."""
    from repro.configs.cnn import smoke_cnn_config as jcnn_config
    from repro.core import pruning as jpruning
    from repro.models.cnn import SparseCNN as JSparseCNN
    from repro_torch.configs.cnn import smoke_cnn_config
    from repro_torch.core import pruning
    from repro_torch.models.cnn import SparseCNN

    jm = JSparseCNN(jcnn_config("sparse-cnn-tiny"))
    jp = jax.tree_util.tree_map(lambda x: jnp.abs(x) + 0.01 if x.ndim >= 2 else x,
                                jm.init(jax.random.PRNGKey(0)))
    tm = SparseCNN(smoke_cnn_config("sparse-cnn-tiny")).load_state(
        params_from_numpy(tp.to_numpy(jp), "cpu"))
    mods = [(lambda p, k=f"l{i}": p[k], lambda p, sub, k=f"l{i}": {**p, k: sub}, m)
            for i, m in enumerate(jm.layers())]
    sched = None if step is None else (JSchedule(0, 10), PruneSchedule(0, 10))
    want = jpruning.make_constrain_fn(mods, sched and sched[0])(jp, step)
    pruning.make_constrain_fn(tm.layers(), sched and sched[1])(step)
    for i in range(len(tm.layers())):
        assert np.array_equal(np.asarray(want[f"l{i}"]["w"]), tm.state()[f"l{i}"]["w"].numpy())
    sparse = [i for i, m in enumerate(tm.layers()) if not m.fmt.is_dense]  # not the C = 3 stem
    fmts_j = {f"l{i}": (jm.layers()[i].fmt, want[f"l{i}"]["w"].reshape(
        -1, want[f"l{i}"]["w"].shape[-1])) for i in sparse}
    fmts_t = {f"l{i}": (tm.layers()[i].fmt, tm.layers()[i].w.reshape(
        -1, tm.layers()[i].w.shape[-1])) for i in sparse}
    assert pruning.global_dbb_stats(None, fmts_t) == jpruning.global_dbb_stats(None, fmts_j)
    tree = {"a": np.abs(np.random.default_rng(1).normal(size=(16, 8))).astype(np.float32),
            "b": {"c": np.ones((12, 4), np.float32), "d": np.ones((8,), np.float32)}}
    jt = jpruning.prune_tree_to_dbb(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jax_fmt(3), min_k=16)
    tt = pruning.prune_tree_to_dbb(jax.tree_util.tree_map(torch.from_numpy, tree),
                                   DBBFormat(8, 3, "matrix"), min_k=16)
    for a, b in zip(jax.tree_util.tree_leaves(jt), port_leaves(tt)):
        assert np.array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------- gradients and remat


def grads_of(tm, batch):
    leaves = port_leaves(tm.params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tm.loss(to_device(batch, "cpu"))
    return loss, torch.autograd.grad(loss, leaves)


def test_gradients_match_the_reference():
    jm, tm = small_models()
    jp = load_reference_params(jm, tm)
    batch = SyntheticTokens(tm.cfg, DataConfig(seq_len=16, global_batch=2)).batch(0)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jbatch(batch))
    tl, tg = grads_of(tm, batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for name, a, b in zip(leaf_names(jg), leaves_np(jg), leaves_np(list(tg))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fp32", [True, False])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_no_remat_bit_for_bit(remat, fp32):
    _, tm = small_models(fp32)
    tm.init(torch.Generator().manual_seed(1), "cpu")
    batch = SyntheticTokens(tm.cfg, DataConfig(seq_len=16, global_batch=2)).batch(1)
    base = tm.cfg
    l0, g0 = grads_of(tm, batch)
    tm.cfg = dataclasses.replace(base, remat=remat)
    l1, g1 = grads_of(tm, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    tm.cfg = dataclasses.replace(base, remat="some")
    with pytest.raises(ValueError, match="remat"):
        grads_of(tm, batch)


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("compression", [False, True])
def test_apply_updates_from_identical_gradients(master, compression):
    """Three updates of a tree with a vector, a matrix and a stacked leaf
    (bf16 leaves give the state a ``master``), from the same gradients."""
    rng = np.random.default_rng(3)
    dt = np.float32
    params = {"a": rng.normal(size=(4, 8, 16)).astype(dt), "b": rng.normal(size=(16,)).astype(dt),
              "w": rng.normal(size=(16, 8)).astype(dt)}
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=6, grad_compression=compression)
    jcfg, tcfg = jadamw.OptConfig(**cfg_kw), adamw.OptConfig(**cfg_kw)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if master else (jnp.float32, torch.float32)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tpar = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    jst, tst = jadamw.init_state(jp, jcfg), adamw.init_state(tpar, tcfg)
    assert set(tst) == set(jst) and ("master" in tst) == master and ("ef" in tst) == compression
    for step in range(3):
        g = {k: rng.normal(size=v.shape).astype(dt) * (step + 1) for k, v in params.items()}
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        jp, jst, jmet = jadamw.apply_updates(jp, jg, jst, step, jcfg)
        _, tst, tmet = adamw.apply_updates(tpar, tg, tst, step, tcfg)
        assert tmet["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        for part in ("m", "v") + (("master",) if master else ()):
            for k in params:
                assert_leaf_close(tst[part][k].numpy(), np.asarray(jst[part][k]), f"{part}/{k}")
        for k in params:
            got = tpar[k].float().numpy()
            want = np.asarray(jp[k].astype(jnp.float32))
            if master:
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
                assert (np.abs(got - want) <= ulp).all(), k
            else:
                assert_leaf_close(got, want, k)
        if compression:
            for k in params:  # the residual: a code may move by one at a rounding tie
                scale = float(jnp.max(jnp.abs(jst["ef"][k]))) + 1e-30
                assert np.abs(tst["ef"][k].numpy() - np.asarray(jst["ef"][k])).max() <= scale


def assert_leaf_close(got, want, what, tol=1e-6):
    """Within ``tol`` of the leaf's largest magnitude, entry by entry."""
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 120])
def test_schedule_matches(step):
    cfg_kw = dict(peak_lr=3e-4, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    got = adamw.schedule(step, adamw.OptConfig(**cfg_kw))
    want = float(jadamw.schedule(step, jadamw.OptConfig(**cfg_kw)))
    assert got == pytest.approx(want, rel=1e-6)


# -------------------------------------------------------------- the pipeline


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "internvl2-2b", "musicgen-medium"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_batches_equal_the_references(arch, hosts):
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    for host in range(hosts):
        dk = dict(seq_len=16, global_batch=4, host_index=host, host_count=hosts)
        js, ts = JTokens(jcfg, JData(**dk)), SyntheticTokens(tcfg, DataConfig(**dk))
        assert ts.local_batch == js.local_batch and ts.vocab == js.vocab
        for step in (0, 7):
            a, b = js.batch(step), ts.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        dev = to_device(ts.batch(0), "cpu")
        assert dev["tokens"].dtype == dev["labels"].dtype == torch.int64
        assert all(v.dtype == torch.float32 for k, v in dev.items() if k not in ("tokens", "labels"))
    with pytest.raises(ValueError, match="split"):
        SyntheticTokens(tcfg, DataConfig(global_batch=3, host_count=2))


def test_prefetcher_resumes_at_step():
    cfg = smoke_config("codeqwen1.5-7b")
    src = SyntheticTokens(cfg, DataConfig(seq_len=16, global_batch=2))
    pf = Prefetcher(src, start_step=5)
    try:
        got = [pf.next() for _ in range(3)]
    finally:
        pf.stop()
    assert not pf._thread.is_alive()
    jsrc = JTokens(jsmoke("codeqwen1.5-7b"), JData(seq_len=16, global_batch=2))
    jpf = JPrefetcher(jsrc, start_step=5)
    try:
        want = [jpf.next() for _ in range(3)]
    finally:
        jpf.stop()
    for (s, b), (js, jb) in zip(got, want):
        assert s == js and np.array_equal(b["tokens"], jb["tokens"])


# ---------------------------------------------------------------- the step


OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)


def test_one_train_step_and_six_match_the_reference():
    """The port's ``Trainer`` against the reference's, both from the
    reference's parameters: one step, then six (the loss of each logged
    step, the parameters, the optimizer state's count)."""
    data = dict(seq_len=16, global_batch=2)
    results = {}
    for total in (1, 6):
        jm, tm = small_models()
        jp = load_reference_params(jm, tm)
        start = leaves_np(jp)
        jt = JTrainer(jm, jadamw.OptConfig(**OPT), JData(**data),
                      JLoop(total_steps=total, log_every=1))
        jout, jst, jhist = jt.run(jp, jadamw.init_state(jp, jt.opt_cfg), 0)
        tt = Trainer(tm, adamw.OptConfig(**OPT), DataConfig(**data),
                     LoopConfig(total_steps=total, log_every=1), device="cpu")
        noise = noise_entries(tm, tt.source.batch(0))
        tout, tst, thist = tt.run(tm.params, adamw.init_state(tm.params, tt.opt_cfg), 0)
        assert [s for s, _ in thist] == [s for s, _ in jhist] == list(range(total))
        for (_, a), (_, b) in zip(jhist, thist):
            assert abs(a - b) <= 1e-5 * abs(a), (a, b)
        lrs = [adamw.schedule(s, tt.opt_cfg) for s in range(total)]
        results[total] = assert_trees_close(jout, tout, rtol=2e-4, atol=2e-5, noise=noise,
                                            start=start, lrs=lrs, opt=tt.opt_cfg)
        assert int(tst["count"]) == int(jst["count"]) == total
        assert len(tt.data_wait_s) == total
    assert results[1][1] == 0  # one step holds every entry to (rtol, atol)
    print("worst ratio to the bound, entries held to the reach:", results)


def test_train_step_constrains_with_its_schedule():
    """With a DBB config each step projects onto the annealed bound, as the
    reference's step does, and lands on the target at the schedule's end."""
    jm, tm = small_models()
    jp = load_reference_params(jm, tm, constrain=False)
    jopt, topt = jadamw.OptConfig(**OPT), adamw.OptConfig(**OPT)
    jstep = jax.jit(jmake_train_step(jm, jopt, JSchedule(0, 2)))
    jst, tst = jadamw.init_state(jp, jopt), adamw.init_state(tm.params, topt)
    src = SyntheticTokens(tm.cfg, DataConfig(seq_len=16, global_batch=2))
    marks = []
    tstep = make_train_step(tm, topt, PruneSchedule(0, 2), mark=marks.append)
    noise, start = noise_entries(tm, src.batch(0)), leaves_np(jp)
    for step in range(3):
        b = src.batch(step)
        jp, jst, jmet = jstep(jp, jst, jbatch(b), jnp.int32(step))
        _, tst, tmet = tstep(tm.params, tst, to_device(b, "cpu"), step)
        assert tmet["step"] == step and set(tmet) == set(jmet)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(float(jmet["loss"]))
    assert marks == ["backward", "update", "constrain"] * 3
    assert_trees_close(jp, tm.params, rtol=2e-4, atol=2e-5, noise=noise, start=start,
                       lrs=[adamw.schedule(s, topt) for s in range(3)], opt=topt)
    for path, pdef in dbb_leaves(tm.defs()):
        for sl in matrices(tree_get(tm.params, path)):
            assert satisfies_dbb(sl, pdef.dbb), path


# ------------------------------------------------------- resume and preempt


def _train(total, ckpt_dir, ckpt_every=100, **kw):
    _, tm = small_models(fp32=False)
    t = Trainer(tm, adamw.OptConfig(**OPT), DataConfig(seq_len=16, global_batch=2),
                LoopConfig(total_steps=total, ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                           log_every=100), device="cpu", **kw)
    return t, t.run()


def test_kill_resume_equivalence(tmp_path):
    """6 steps straight equal 3 steps, a checkpoint at step 2, a "crash", a
    resume and 3 more (the twin of the reference's test, its tolerance)."""
    _, (pa, sa, _) = _train(6, tmp_path / "a")
    _train(3, tmp_path / "b", ckpt_every=2)
    assert store.latest_step(tmp_path / "b") == 2
    _, (pb, sb, _) = _train(6, tmp_path / "b")
    for a, b in zip(port_leaves((pa, sa)), port_leaves((pb, sb))):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   rtol=2e-4, atol=2e-5)
        assert torch.equal(a, b)  # one package, one device: the same bits


def test_the_reference_store_reads_a_port_trained_checkpoint(tmp_path):
    """(params, opt_state) written by the port's Trainer (bf16 leaves: a
    master copy in the state) restore in the reference's store into the
    reference's ``init_state`` tree, bit for bit; and back."""
    t, (pa, sa, _) = _train(3, tmp_path, ckpt_every=2, prune_schedule=PruneSchedule(0, 2))
    jm, _ = small_models(fp32=False)
    jp = jm.init(jax.random.PRNGKey(0))
    like = (jp, jadamw.init_state(jp, jadamw.OptConfig(**OPT)))
    got, manifest = jstore.restore(tmp_path, like)
    assert manifest["step"] == 2
    written, _ = store.restore(tmp_path, (pa, sa))
    # the reference casts each leaf to its template's dtype (its init makes
    # the 'scaled' leaves fp32 under a bf16 config, the port's bf16): equal values
    for a, b, ref in zip(jax.tree_util.tree_leaves(got), port_leaves(written),
                         jax.tree_util.tree_leaves(like)):
        assert a.dtype == ref.dtype
        assert np.array_equal(np.asarray(a.astype(jnp.float32)), b.detach().float().numpy())
    back_dir = tmp_path / "from_reference"
    jstore.save(back_dir, 2, got)
    again, _ = store.restore(back_dir, (pa, sa))
    assert all(torch.equal(a, b) for a, b in zip(port_leaves(again), port_leaves(written)))


def test_preemption_flushes_checkpoint(tmp_path):
    _, tm = small_models(fp32=False)
    t = Trainer(tm, adamw.OptConfig(), DataConfig(seq_len=16, global_batch=2),
                LoopConfig(total_steps=50, ckpt_dir=str(tmp_path), ckpt_every=1000,
                           log_every=100), device="cpu")
    params, opt_state, start = t.init_or_resume()
    t._preempted = True  # a SIGTERM delivered
    _, _, history = t.run(params, opt_state, 0)
    assert store.latest_step(tmp_path) == 0 and history == [(0, history[0][1])]


def test_loss_decreases_with_dbb_constraint():
    """The twin of the reference's integration test: 60 steps annealed over
    20 descend by more than 0.2 and every DBB leaf ends on its bound."""
    _, tm = small_models(fp32=False)
    t = Trainer(tm, adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=60),
                DataConfig(seq_len=32, global_batch=4),
                LoopConfig(total_steps=60, log_every=59), PruneSchedule(0, 20), device="cpu")
    params, _, history = t.run(generator=torch.Generator().manual_seed(0))
    assert history[-1][1] < history[0][1] - 0.2, history
    for path, pdef in dbb_leaves(tm.defs()):
        for sl in matrices(tree_get(params, path)):
            assert satisfies_dbb(sl, pdef.dbb), path


# ---------------------------------------------------------------- launcher


def test_launcher_trains_on_the_cpu(capsys, monkeypatch):
    history = launch_train.main(["--arch", "codeqwen1.5-7b", "--smoke", "--steps", "3",
                                 "--device", "cpu", "--seq-len", "32", "--global-batch", "2"])
    assert [s for s, _ in history] == [0, 2]
    assert "loss:" in capsys.readouterr().out
    # the mesh needs torchrun's world (tests/test_torch_distributed.py runs one)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "codeqwen1.5-7b", "--smoke", "--distributed", "--device",
                           "cpu"])
    with pytest.raises(ValueError, match="--distributed"):
        launch_train.main(["--arch", "codeqwen1.5-7b", "--smoke", "--multi-pod", "--device",
                           "cpu"])


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "codeqwen1.5-7b", "--smoke", "--steps", "1"])
