"""repro_torch's MoE decoder held against the JAX reference on the CPU:
``MoEMLP`` (grouped expert choice at prefill, global at decode, the shared
experts, ties, the combine, ``aux_loss``), the MoE ``LM``'s forward, decode
step, greedy generation, calibration, INT8 quantization and frozen plan, the
golden fixture the card reads, ``decode_step`` with a tensor position, and
``generate``'s compiled and eager runs.

Parameters come from the JAX package (``torch_parity.to_numpy`` ->
``interop.params_from_numpy``); inputs from a numpy seed. JAX runs in ref
mode; the port runs its kernels' plain versions. Models:
``smoke_config("moonshot-v1-16b-a3b")`` (8 experts, top-2, 2 shared, d_ff
256, bf16) and the same in fp32 (``moe-fp32``).

Tolerances, each with the value this file measured beside it:
  - defs, compressed values and indices, int8 codes, activation-stat names,
    the top-cap order on ties, greedy tokens (fp32), the plan against the
    unplanned forward, a tensor position against an int: equal;
  - fp32 outputs within 1e-5 relative L2 (summation order);
  - bf16 outputs within 2e-2 relative L2, decode against the reference's
    unscanned decode (``scan_layers=False``, ``remat='none'``: op by op,
    every cast kept, the form the port's loop over groups mirrors). The
    scanned decode keeps fp32 between the bf16 ops XLA fuses, and a hidden
    state that moves by an ulp can move a token across an expert's cap:
    that compile is 0.13 from the port at a step where it flips, while the
    unscanned one matches the port bit for bit until a late step;
  - the quantized forward within 5e-3: the router's fp32 probabilities
    differ from XLA's by an ulp (summation order), which can move a gate's
    bf16 rounding and from there an int8 code of the next layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models.common import Param as JParam
from repro.models.common import init_params as jinit
from repro.models.mlp import MoEMLP as JMoE
from repro.models.model import LM as JLM
from repro_torch.configs import registry as treg
from repro_torch.core.act_sparsity import collect_activations
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBWeight
from repro_torch.interop import flatten, params_from_numpy, unflatten
from repro_torch.launch import serve
from repro_torch.models.common import dbb_leaves, param_leaves, tree_get
from repro_torch.models.mlp import MoEMLP, combine, top_cap
from repro_torch.models.model import LM
from repro_torch.models.plan import capture
from repro_torch.train.step import make_prefill, make_serve_step

ARCH = tp.MOE_ARCH


def rel_l2(a, b) -> float:
    def arr(x):
        return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)

    a, b = arr(a), arr(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fp32(mod, f32):
    return dataclasses.replace(mod.smoke_config(ARCH), param_dtype=f32, compute_dtype=f32)


CONFIGS = {
    "moe": (lambda: jreg.smoke_config(ARCH), lambda: treg.smoke_config(ARCH)),
    "moe-fp32": (lambda: _fp32(jreg, jnp.float32), lambda: _fp32(treg, torch.float32)),
    "moe-no-shared": (lambda: dataclasses.replace(jreg.smoke_config(ARCH), num_shared_experts=0),
                      lambda: dataclasses.replace(treg.smoke_config(ARCH), num_shared_experts=0)),
}
TOL = {"moe": 2e-2, "moe-fp32": 1e-5, "moe-no-shared": 2e-2}


class Ref:
    """One config's JAX reference: compressed params, tokens, prefill logits
    and cache, calibration stats, quantized params."""

    def __init__(self, key, seed=0, batch=2, seq=32):
        jcfg, tcfg = CONFIGS[key]
        self.key, self.jcfg, self.tcfg = key, jcfg(), tcfg()
        self.jm = JLM(self.jcfg)
        self.dense = self.jm.init(jax.random.PRNGKey(seed))
        self.params = self.jm.compress(self.dense)
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, self.jcfg.vocab_size, (batch, seq)).astype(np.int32)
        self.logits, self.cache, self.stats = self.jm.forward(
            self.params, {"tokens": jnp.asarray(self.tokens)}, return_cache=True,
            collect_act_stats=True)
        self.qparams = self.jm.quantize(self.params, self.stats)

    def port(self, tree=None) -> LM:
        return LM(self.tcfg).load_params(
            params_from_numpy(tp.to_numpy(self.params if tree is None else tree), "cpu"))


_REFS = {}


def ref(key) -> Ref:
    if key not in _REFS:
        _REFS[key] = Ref(key)
    return _REFS[key]


def _fwd(model, tokens, **kw):
    with torch.no_grad():
        return model.forward(torch.from_numpy(tokens), **kw)


# ---------------------------------------------------------------- MoEMLP


def _mlp_pair(key, seed=0):
    jcfg, tcfg = CONFIGS[key]
    jc, tc = jcfg(), tcfg()
    jm = JMoE(jc)
    p = jinit(jm.defs(), jax.random.PRNGKey(seed), jc.param_dtype)
    return jm, p, MoEMLP(tc), params_from_numpy(tp.to_numpy(p), "cpu"), tc.compute_dtype


def _mlp_inputs(shape, dtype, seed=0, dup=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dup:  # tokens 2k and 2k+1 the same: their routing scores tie exactly
        flat = x.reshape(-1, shape[-1])
        flat[1::2] = flat[0::2]
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("key", list(CONFIGS))
@pytest.mark.parametrize("shape,dup", [((2, 16, 128), False), ((4, 1, 128), False),
                                       ((4, 1, 128), True), ((2, 16, 128), True)],
                         ids=["grouped", "global", "global-ties", "grouped-ties"])
def test_moe_mlp_matches_reference(key, shape, dup):
    """Prefill (s > 1: grouped expert choice within each example) and decode
    (s = 1: global over the batch's tokens), with and without the shared
    experts; ``dup`` makes pairs of tokens equal, so experts meet exact ties
    and must take the lower index first, as ``jax.lax.top_k`` does."""
    # measured (grouped, global, global-ties, grouped-ties): bf16 3.4e-5, 6.2e-4,
    # 1.1e-3, 3.1e-4; fp32 2.4e-7 to 4.8e-7; bf16 without shared experts 0
    jm, jp, tm, tp_, dt = _mlp_pair(key)
    xj, xt = _mlp_inputs(shape, dt, dup=dup)
    want = jm(jp, xj)
    with torch.no_grad():
        got = tm(tp_, xt)
    assert got.shape == tuple(want.shape) and got.dtype == dt
    assert rel_l2(got, np.asarray(want, np.float32)) <= TOL[key]


def test_top_cap_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(1)
    scores = rng.choice(np.array([0.1, 0.25, 0.5], np.float32), size=(6, 9))
    for cap in (1, 3, 9):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), cap)
        tv, ti = top_cap(torch.from_numpy(scores), cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_routing_of_duplicated_tokens_equals_the_reference():
    """At decode (cap 1 here) two equal tokens tie for every expert: each
    expert takes the lower-indexed one, in the reference and the port."""
    jm, jp, tm, tp_, _ = _mlp_pair("moe-fp32")
    x = np.repeat(np.random.default_rng(2).normal(size=(2, 1, 128)).astype(np.float32), 2, 0)
    jprobs = jax.nn.softmax(x.reshape(4, 128) @ np.asarray(jp["router"]), axis=-1)
    _, jidx = jax.lax.top_k(jprobs.T, 1)
    probs = tm._probs(tp_, torch.from_numpy(x.reshape(4, 128)))
    _, idx = top_cap(probs.T, 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert set(idx.reshape(-1).tolist()) <= {0, 2}  # never the later copy


def test_combine_sums_each_tokens_rows_and_keeps_nan_in_its_token():
    rng = np.random.default_rng(3)
    e, cap, n, d = 4, 3, 6, 5
    idx = torch.from_numpy(np.stack([rng.choice(n, cap, replace=False) for _ in range(e)]))
    out = torch.from_numpy(rng.normal(size=(e, cap, d)).astype(np.float32))
    want = torch.zeros(n, d, dtype=torch.float64)
    for i in range(e):  # the reference's scatter-add, in float64
        want.index_add_(0, idx[i], out[i].double())
    torch.testing.assert_close(combine(out, idx, n).double(), want, rtol=1e-6, atol=1e-6)
    out[1, 0, 2] = float("nan")
    got = combine(out, idx, n)
    assert torch.isnan(got[idx[1, 0], 2]) and int(torch.isnan(got).sum()) == 1
    # batched over a leading axis (the grouped path)
    b2 = combine(torch.stack([out, out]), torch.stack([idx, idx]), n)
    for half in b2:
        torch.testing.assert_close(half, got, rtol=0, atol=0, equal_nan=True)


def test_combine_rounds_after_each_add_in_expert_order():
    """In bf16 the sum is the reference's scatter-add's to the bit (XLA adds
    the updates in order, rounding each), not the sum rounded once."""
    rng = np.random.default_rng(5)
    e, cap, n, d = 8, 2, 4, 64
    idx = np.stack([rng.choice(n, cap, replace=False) for _ in range(e)])
    out = jnp.asarray(rng.normal(size=(e, cap, d)), jnp.bfloat16)
    want = jnp.zeros((n, d), jnp.bfloat16).at[idx.reshape(-1)].add(out.reshape(-1, d))
    got = combine(torch.from_numpy(np.asarray(out.astype(jnp.float32))).bfloat16(),
                  torch.from_numpy(idx), n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("router,value", [("zeros", 1.0), ("concentrated", None)])
def test_aux_loss_matches_the_reference(router, value):
    """``TestMoEAuxLoss``'s two routers: a uniform one pins the loss at 1.0,
    a concentrated one exceeds 4; the port's value equals the reference's."""
    cfg_j = dataclasses.replace(jreg.get_config("qwen2-tiny"), num_experts=8, top_k=2)
    cfg_t = dataclasses.replace(treg.get_config("qwen2-tiny"), num_experts=8, top_k=2)
    w = np.zeros((cfg_j.d_model, 8), np.float32)
    if router == "concentrated":
        w[:, 0] = 50.0
        x = np.ones((2, 16, cfg_j.d_model), np.float32)
    else:
        x = np.random.default_rng(0).normal(size=(2, 16, cfg_j.d_model)).astype(np.float32)
    want = float(JMoE(cfg_j).aux_loss({"router": jnp.asarray(w)}, jnp.asarray(x)))
    got = float(MoEMLP(cfg_t).aux_loss({"router": torch.from_numpy(w)}, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if value is not None:
        np.testing.assert_allclose(got, value, rtol=1e-6)
    else:
        assert got > 4.0


# ------------------------------------------------------------ the MoE LM


def test_moe_lm_is_built_and_other_families_still_raise():
    """The MoE builds, and so does the family this test once held refused,
    a frontend's (internvl2-2b, item 12e), at full and at smoke size."""
    assert LM(treg.smoke_config(ARCH)).cfg.is_moe
    for cfg in (treg.get_config("internvl2-2b"), treg.smoke_config("internvl2-2b")):
        assert LM(cfg).cfg.frontend == "vision"


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_the_mla_moe_lm_is_built(smoke):
    """deepseek-v3-671b (MoE with MLA, 256 experts at full size) builds."""
    cfg = (treg.smoke_config if smoke else treg.get_config)("deepseek-v3-671b")
    assert LM(cfg).cfg.mixer == "mla"


def _jax_leaves(defs):
    flat, _ = jax.tree_util.tree_flatten_with_path(defs, is_leaf=lambda x: isinstance(x, JParam))
    return {tuple(k.key for k in path): p for path, p in flat}


@pytest.mark.parametrize("key", list(CONFIGS))
def test_defs_paths_and_shapes_equal(key):
    jcfg, tcfg = CONFIGS[key]
    jl = _jax_leaves(JLM(jcfg()).defs())
    tl = dict(param_leaves(LM(tcfg()).defs()))
    assert set(tl) == set(jl)
    assert ("layers", "b0", "mlp", "we_up") in tl
    for path, p in tl.items():
        q = jl[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
        assert (p.dbb is None) == (q.dbb is None), path


def test_compress_leaves_the_expert_stacks_dense():
    r = ref("moe")
    model = r.port(r.dense).compress()
    mlp = model.state()["layers"]["b0"]["mlp"]
    for name in ("we_up", "we_gate", "we_down", "router"):
        assert isinstance(mlp[name], torch.Tensor), name
    for path, _ in dbb_leaves(model.defs()):
        jw, tw = tree_get(r.params, path), tree_get(model.state(), path)
        assert isinstance(tw, DBBWeight)
        np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jw.indices))
        np.testing.assert_array_equal(tw.values.float().numpy(), np.asarray(jw.values, np.float32))
    assert any(path[3] == "shared" for path, _ in dbb_leaves(model.defs()))


def test_init_draws_the_expert_stacks_in_the_param_dtype():
    cfg = treg.smoke_config(ARCH)
    model = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
    w = model.state()["layers"]["b0"]["mlp"]["we_up"]
    assert w.dtype == torch.bfloat16 and w.shape == (cfg.num_groups, 8, 128, 256)
    # each (E, d, f) slice is a fan-in scaled truncated normal over d
    std = float(w.float().std())
    assert 0.5 / np.sqrt(128) < std < 1.0 / np.sqrt(128) and float(w.float().abs().max()) <= 2.1 / np.sqrt(128)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_prefill_logits(key):
    # measured: 4.9e-5 (bf16), 5.6e-7 (fp32), 2.5e-3 (bf16, no shared experts)
    r = ref(key)
    logits, cache = _fwd(r.port(), r.tokens, return_cache=True)
    assert logits.shape == tuple(r.logits.shape) and logits.dtype == r.tcfg.compute_dtype
    assert rel_l2(logits, r.logits) <= TOL[key]
    jk = np.asarray(jax.tree_util.tree_leaves(r.cache)[0], np.float32)
    assert rel_l2(cache["groups"]["b0"]["k"], jk) <= TOL[key]


def _unscanned(r):
    return JLM(dataclasses.replace(r.jcfg, scan_layers=False, remat="none"))


def _jax_teacher_forced(r, prompt, forced, max_len):
    jm, p = _unscanned(r), r.params
    _, cache = jm.forward(p, {"tokens": jnp.asarray(prompt)}, return_cache=True)
    cache = tp.jax_pad_cache(cache, prompt.shape[1], max_len)
    out = []
    for i in range(forced.shape[1]):
        lg, cache = jm.decode_step(p, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])},
                                   jnp.int32(prompt.shape[1] + i))
        out.append(np.asarray(lg, np.float32))
    return out


@pytest.mark.parametrize("key", ["moe", "moe-fp32"])
def test_teacher_forced_decode_logits(key):
    """Decode steps (global expert choice over the batch's 2 tokens, cap 1)
    after a prefill, each step's logits against the reference's unscanned
    decode."""
    # measured: worst step 4.6e-3 (bf16), 7.5e-7 (fp32)
    r = ref(key)
    prompt, forced = r.tokens[:, :24], r.tokens[:, 24:]
    want = _jax_teacher_forced(r, prompt, forced, 32)
    model = r.port()
    last, cache = make_prefill(model)({"tokens": torch.from_numpy(prompt)})
    cache = serve.pad_cache(cache, 24, 32)
    step = make_serve_step(model)
    worst = 0.0
    for i in range(forced.shape[1]):
        lg, cache = step(cache, {"tokens": torch.from_numpy(forced[:, i:i + 1])},
                         torch.tensor(24 + i))
        worst = max(worst, rel_l2(lg, want[i]))
    assert worst <= TOL[key]


def test_greedy_generation_tokens_equal():
    """8 greedy tokens of the fp32 MoE: the reference's generate against
    the port's, compiled (the default) and eager."""
    r = ref("moe-fp32")
    prompt = r.tokens[:, :16]
    jtoks, _ = jserve.generate(r.jm, r.params, {"tokens": jnp.asarray(prompt)}, gen_len=8,
                               max_len=24)
    for graph in (True, False):
        rec = serve.generate(r.port(), {"tokens": torch.from_numpy(prompt)}, gen_len=8,
                             max_len=24, graph=graph)
        np.testing.assert_array_equal(rec["tokens"].numpy(), np.asarray(jtoks))


def test_act_stat_names_and_quantize():
    """Calibration records the router's input (under the block's ``mlp``
    scope) and the shared experts' (``mlp.shared``) as the reference does;
    quantize gives its int8 codes and act scales, and leaves the router and
    the expert stacks as they are."""
    r = ref("moe")
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    assert {s.name for s in stats} == {s.name for s in r.stats}
    assert "g0.b0.mlp" in {s.name for s in stats}
    assert "g0.b0.mlp.shared.w_down" in {s.name for s in stats}
    model.quantize(stats)
    for path, _ in dbb_leaves(model.defs()):
        jq, tq = tree_get(r.qparams, path), tree_get(model.state(), path)
        assert isinstance(tq, QuantDBBWeight)
        np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
        aq = path[:-1] + (path[-1] + "_aq",)
        # measured: 0 (bf16: the port rounds where the reference does)
        np.testing.assert_allclose(tree_get(model.state(), aq).numpy(),
                                   np.asarray(tree_get(r.qparams, aq)), rtol=1e-5)
    assert isinstance(model.state()["layers"]["b0"]["mlp"]["we_down"], torch.Tensor)


def test_quantized_forward_and_plan():
    """The INT8 MoE: its forward against the reference's unscanned forward,
    and the frozen plan (shared experts staged int8, the router and the
    experts raw) equal to the unplanned forward bit for bit."""
    r = ref("moe")
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    model.quantize(stats)
    want = _unscanned(r).forward(r.qparams, {"tokens": jnp.asarray(r.tokens)})
    got = _fwd(model, r.tokens)
    # measured: 1.9e-3
    assert rel_l2(got, want) <= 5e-3
    plan = model.plan(batch=2, seq=32)
    jplan = r.jm.plan(r.qparams, batch=2, seq=32, tune="off")
    assert [l.name for l in plan.layers] == [l.name for l in jplan.layers]
    with torch.no_grad():
        assert torch.equal(plan(torch.from_numpy(r.tokens)), got)
    assert plan.trace_count == 1


# ------------------------------------------------- the position as a tensor


@pytest.mark.parametrize("arch", ["qwen2-tiny", "local", ARCH, "deepseek-v3-671b"])
def test_decode_step_takes_a_tensor_position(arch):
    """The same step at an int position and at a 0-d int64 tensor gives the
    same bits and the same cache, for global, windowed (a ring of 8 slots,
    written past its capacity), MoE and MLA blocks."""
    if arch == "local":
        cfg = dataclasses.replace(treg.get_config("qwen2-tiny"), block_pattern=("attn", "local"),
                                  num_layers=3, local_window=8)
    else:
        cfg = (treg.smoke_config(arch) if arch in (ARCH, "deepseek-v3-671b")
               else treg.get_config(arch))
    model = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 12)).astype(np.int32))
    a, b = model.init_cache(2, 12), model.init_cache(2, 12)
    with torch.no_grad():
        for i in range(12):
            la, a = model.decode_step(a, toks[:, i:i + 1], i)
            lb, b = model.decode_step(b, toks[:, i:i + 1], torch.tensor(i, dtype=torch.int64))
            assert torch.equal(la, lb), i
    assert all(torch.equal(x, y) for x, y in zip(flatten_cache(a), flatten_cache(b)))


def flatten_cache(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flatten_cache(tree[k])]
    return [tree]


# ------------------------------------------------------------ generate


def test_generate_compiled_equals_eager_on_the_cpu():
    """On the CPU ``graph=True`` captures nothing: it runs the same prefill
    and step functions as ``graph=False`` and counts two staged signatures;
    the tokens and the kept logits are equal, and every forward is counted."""
    r = ref("moe")
    prompt = {"tokens": torch.from_numpy(r.tokens[:, :16])}
    recs = {g: serve.generate(r.port(), prompt, gen_len=6, max_len=22, keep=(0, 4), graph=g)
            for g in (True, False)}
    assert recs[True]["captures"] == 2 and recs[False]["captures"] == 0
    assert torch.equal(recs[True]["tokens"], recs[False]["tokens"])
    for i in (0, 4):
        assert torch.equal(recs[True]["logits"][i], recs[False]["logits"][i])
    for rec in recs.values():
        # 5 prefills (untimed, 3 timed, the one whose cache decode reads)
        # and 6 steps (the warm-up and 5); no graph, so no replay
        assert rec["forwards"] == {"prefill": 5, "decode": 6}
        assert rec["replays"] == {"prefill": 0, "decode": 0} and rec["graph_launches"] == {}
    one = serve.generate(r.port(), prompt, gen_len=1, max_len=17)
    assert one["captures"] == 1 and one["tokens"].shape == (2, 1)
    assert torch.equal(one["tokens"], recs[True]["tokens"][:, :1])


def test_no_capture_while_collecting_activations():
    with collect_activations():
        with pytest.raises(RuntimeError, match="collect"):
            capture(lambda: None, None, "cpu")


# -------------------------------------------------------------- fixture


@pytest.fixture(scope="module")
def golden():
    with np.load(tp.FIXTURE_MOE) as z:
        return unflatten(z)


def test_moe_fixture_matches_the_reference_today(golden):
    live, flat_file = flatten(tp.jax_moe_golden()), flatten(golden)
    assert set(live) == set(flat_file)
    for k, v in live.items():
        np.testing.assert_array_equal(flat_file[k], v, err_msg=k)
    assert tp.FIXTURE_MOE.stat().st_size < 4 << 20


def test_port_on_the_moe_fixture(golden):
    """What chip_smoke.py's phase 8 holds on the card, here on the plain
    versions: the next token equal, prefill and decode logits within 1e-5."""
    model = LM(_fp32(treg, torch.float32)).load_params(params_from_numpy(golden["params"], "cpu"))
    tokens = torch.from_numpy(golden["tokens"])
    rec = serve.generate(model, {"tokens": tokens}, gen_len=2, max_len=tokens.shape[1] + 1,
                         keep=(0,))
    np.testing.assert_array_equal(rec["tokens"][:, :1].numpy(), golden["next"])
    # measured: 6.3e-7 and 6.2e-7
    assert rel_l2(_fwd(model, golden["tokens"])[:, -1:], golden["prefill"]) <= 1e-5
    assert rel_l2(rec["logits"][0], golden["decode"]) <= 1e-5
