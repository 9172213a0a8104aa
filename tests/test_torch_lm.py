"""repro_torch's LM serving path held against the JAX reference on the CPU:
the registry, ``defs()``, ``compress()``, calibration and ``quantize()``,
prefill, greedy generation, teacher-forced decode (a ring buffer past its
capacity included), the quantized forward, the frozen plan, the golden
fixture the card reads, and the entry points.

Parameters come from the JAX package (``torch_parity.to_numpy`` ->
``interop.params_from_numpy``); tokens from a numpy seed. JAX runs in ref
mode (the LM configs' default ``kernel_mode``); the port runs its kernels'
plain versions. Models: ``qwen2-tiny`` (fp32, RMSNorm, SwiGLU, GQA with 2 KV
heads), ``smoke_config("starcoder2-7b")`` (bf16, LayerNorm, GELU, 1 KV head)
and ``qwen2-tiny`` with the block pattern ``('attn', 'local')`` over 3
layers (a window of 8: one scanned group and a tail).

Tolerances, each with the value this file measured beside it:
  - defs, compressed values and indices, int8 codes and weight scales,
    activation-stat names, greedy tokens, the plan against the unplanned
    forward: equal;
  - calibrated absmax and act scales within 1e-5 relative (bf16 included:
    the port rounds every bf16 op where the reference does, so they match
    exactly);
  - fp32 logits within 1e-5 relative L2 (summation order and XLA's fused
    elementwise ops against torch's);
  - bf16 (the starcoder2 smoke) prefill and teacher-forced decode logits
    within 2e-2 relative L2;
  - the quantized forward within 1e-3 (an int8 code may flip at a rounding
    tie), against the reference's forward compiled with XLA's excess
    precision off. By default XLA keeps fp32 between the bf16 elementwise
    ops it fuses in the scanned layer body, so its activations move by an
    ulp where the written cast order rounds, and an activation that moves
    by an ulp can move its int8 code: that default compile is 1.7e-2 from
    the port (and from the reference's own unscanned forward), and is not
    what the reference's code says.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models.common import Param as JParam
from repro.models.model import LM as JLM
from repro_torch.configs import ARCHS, get_config, make_batch, smoke_config
from repro_torch.configs import registry as treg
from repro_torch.core.act_sparsity import ActStats
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBFormat, DBBWeight, dbb_encode
from repro_torch.interop import flatten, params_from_numpy, unflatten
from repro_torch.launch import serve
from repro_torch.models.common import apply_linear, param_leaves, tree_get
from repro_torch.models.model import LM
from repro_torch.train.step import make_prefill, make_serve_step

ROOT = Path(__file__).resolve().parents[1]


def rel_l2(a, b) -> float:
    def arr(x):
        return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)

    a, b = arr(a), arr(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _local_cfg(mod):
    """qwen2-tiny with a local block: one ('attn', 'local') group and a tail."""
    return dataclasses.replace(mod.get_config("qwen2-tiny"), block_pattern=("attn", "local"),
                               num_layers=3, local_window=8)


CONFIGS = {
    "qwen2-tiny": (lambda: jreg.get_config("qwen2-tiny"), lambda: get_config("qwen2-tiny")),
    "starcoder2-smoke": (lambda: jreg.smoke_config("starcoder2-7b"),
                         lambda: smoke_config("starcoder2-7b")),
    "local": (lambda: _local_cfg(jreg), lambda: _local_cfg(treg)),
}


class Ref:
    """One config's JAX reference run: dense and compressed params, tokens,
    the prefill logits and cache, the calibration stats and the quantized
    params and logits."""

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
        self.qlogits = written_rounding_forward(self.jm, self.qparams, self.tokens)

    def port(self, tree=None) -> LM:
        return LM(self.tcfg).load_params(
            params_from_numpy(tp.to_numpy(self.params if tree is None else tree), "cpu"))


def written_rounding_forward(jm, params, tokens):
    """The reference's forward (scanned and rematted as its config says),
    compiled with XLA's excess precision off: every bf16 op rounds where the
    reference's code casts."""
    toks = jnp.asarray(tokens)
    f = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))
    return f.lower(params, toks).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, toks)


_REFS = {}


def ref(key) -> Ref:
    if key not in _REFS:
        _REFS[key] = Ref(key)
    return _REFS[key]


def _fwd(model, tokens, **kw):
    with torch.no_grad():
        return model.forward(torch.from_numpy(tokens), **kw)


# --------------------------------------------------------------- registry


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_registry_copies_every_field(arch, smoke):
    j = (jreg.smoke_config if smoke else jreg.get_config)(arch)
    t = (smoke_config if smoke else get_config)(arch)
    assert sorted(ARCHS) == sorted(jreg.ARCHS)
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert jnp.dtype(jv).name == str(tv).replace("torch.", ""), f.name
        elif f.name == "dbb":
            assert (jv is None) == (tv is None)
            if jv is not None:
                assert (jv.bz, jv.nnz, jv.group) == (tv.bz, tv.nnz, tv.group)
        else:
            assert jv == tv, f.name
    for prop in ("hd", "padded_vocab", "pattern", "num_groups", "tail_pattern"):
        assert getattr(j, prop) == getattr(t, prop), prop


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "recurrentgemma-2b", "internvl2-2b",
                                  "musicgen-medium", "rwkv6-3b"])
def test_unported_families_raise_from_the_constructor(arch):
    """The families once refused by the constructor, MLA, the recurrent
    decoders and (since item 12e) the frontends, all build, at full and at
    smoke size; none raises any more."""
    for cfg in (get_config(arch), smoke_config(arch)):
        assert LM(cfg).cfg is cfg


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_param_count_matches_reference(arch):
    """Every registry config, those the LM does not build yet included
    (``models.model.lm_defs`` describes their trees)."""
    assert get_config(arch).param_count() == jreg.get_config(arch).param_count()


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_active_param_count_matches_reference(arch):
    """The weights a token touches: the MoE's routed stacks at top_k /
    num_experts (deepseek-v3-671b 37.56 B of 703.80 B), all of a dense
    model's."""
    assert get_config(arch).active_param_count() == jreg.get_config(arch).active_param_count()


# ------------------------------------------------------------ the tree


def _jax_leaves(defs):
    flat, _ = jax.tree_util.tree_flatten_with_path(defs, is_leaf=lambda x: isinstance(x, JParam))
    return {tuple(k.key for k in path): p for path, p in flat}


@pytest.mark.parametrize("key", list(CONFIGS))
def test_defs_paths_and_shapes_equal(key):
    jcfg, tcfg = CONFIGS[key]
    jl = _jax_leaves(JLM(jcfg()).defs())
    tl = dict(param_leaves(LM(tcfg()).defs()))
    assert list(tl) == sorted(tl) and set(tl) == set(jl)
    for path, p in tl.items():
        q = jl[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
        assert (p.dbb is None) == (q.dbb is None), path
        if p.dbb is not None:
            assert (p.dbb.bz, p.dbb.nnz, p.dbb.group) == (q.dbb.bz, q.dbb.nnz, q.dbb.group)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_compress_values_and_indices_equal(key):
    r = ref(key)
    model = r.port(r.dense).compress()
    for path, _ in _dbb_paths(model):
        jw, tw = tree_get(r.params, path), tree_get(model.state(), path)
        assert isinstance(tw, DBBWeight) and tw.shape == tuple(jw.shape)
        np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jw.indices))
        np.testing.assert_array_equal(tw.values.float().numpy(),
                                      np.asarray(jw.values, np.float32))


def _dbb_paths(model):
    from repro_torch.models.common import dbb_leaves

    return list(dbb_leaves(model.defs()))


@pytest.mark.parametrize("key", list(CONFIGS))
def test_act_stat_names_and_calibrated_absmax(key):
    r = ref(key)
    _, stats = _fwd(r.port(), r.tokens, collect_act_stats=True)
    jnames = {s.name for s in r.stats}
    assert {s.name for s in stats} == jnames and len(stats) == len(r.stats)
    assert "lm_head" in jnames and any(n.endswith("mixer.wq") for n in jnames)
    jmax = {s.name: s.absmax for s in r.stats}
    worst = max(abs(s.absmax - jmax[s.name]) / jmax[s.name] for s in stats)
    # measured: 3.8e-7 (qwen2-tiny), 2.0e-7 (local), 0 (starcoder2 smoke, bf16)
    assert worst <= 1e-5


@pytest.mark.parametrize("key", list(CONFIGS))
def test_quantize_codes_scales_and_act_scales(key):
    r = ref(key)
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    model.quantize(stats)
    for path, _ in _dbb_paths(model):
        jq, tq = tree_get(r.qparams, path), tree_get(model.state(), path)
        assert isinstance(tq, QuantDBBWeight)
        np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
        np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
        aq_path = path[:-1] + (path[-1] + "_aq",)
        jaq, taq = np.asarray(tree_get(r.qparams, aq_path)), tree_get(model.state(), aq_path)
        assert taq.shape == jaq.shape  # (L,) for a stacked leaf, () for a tail leaf
        # measured: 3.8e-7 (qwen2-tiny), 2.0e-7 (local), 0 (starcoder2 smoke)
        np.testing.assert_allclose(taq.numpy(), jaq, rtol=1e-5)
    # JAX's own stats give JAX's own act scales exactly
    exact = r.port()
    exact.quantize([ActStats(name=s.name, absmax=s.absmax) for s in r.stats])
    for path, _ in _dbb_paths(exact):
        aq_path = path[:-1] + (path[-1] + "_aq",)
        np.testing.assert_array_equal(tree_get(exact.state(), aq_path).numpy(),
                                      np.asarray(tree_get(r.qparams, aq_path)))


# --------------------------------------------------------------- logits


@pytest.mark.parametrize("key,tol", [("qwen2-tiny", 1e-5), ("local", 1e-5),
                                     ("starcoder2-smoke", 2e-2)])
def test_prefill_logits(key, tol):
    # measured: 3.6e-7 (qwen2-tiny), 3.9e-7 (local), 4.9e-8 (starcoder2 smoke, bf16)
    r = ref(key)
    logits, cache = _fwd(r.port(), r.tokens, return_cache=True)
    assert logits.shape == tuple(r.logits.shape) and logits.dtype == r.tcfg.compute_dtype
    assert rel_l2(logits, r.logits) <= tol
    jk = np.asarray(jax.tree_util.tree_leaves(r.cache)[0], np.float32)
    assert rel_l2(cache["groups"]["b0"]["k"], jk) <= tol


def test_prefill_past_q_chunk_runs_chunked_attention():
    """seq 128 over q_chunk 64: two query chunks against the whole K/V."""
    r = ref("qwen2-tiny")
    tokens = np.random.default_rng(5).integers(0, 512, (2, 128)).astype(np.int32)
    assert tokens.shape[1] > r.tcfg.q_chunk
    want = r.jm.forward(r.params, {"tokens": jnp.asarray(tokens)})
    # measured: 4.2e-7
    assert rel_l2(_fwd(r.port(), tokens), want) <= 1e-5


def _quantized_port(r):
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    return model.quantize(stats)


@pytest.mark.parametrize("key", ["qwen2-tiny", "starcoder2-smoke"])
def test_quantized_forward(key):
    """Calibrate, quantize and run the port against the reference's
    quantized forward, compiled with XLA's excess precision off."""
    # measured: 2.3e-7 (qwen2-tiny), 0 (starcoder2 smoke, bf16)
    r = ref(key)
    assert rel_l2(_fwd(_quantized_port(r), r.tokens), r.qlogits) <= 1e-3


@pytest.mark.parametrize("key", ["qwen2-tiny", "starcoder2-smoke"])
def test_quantized_forward_matches_the_unscanned_reference(key):
    """The same against the reference's unscanned forward without remat
    (``scan_layers=False``, ``remat='none'``: op by op, every cast kept),
    the form the port's Python loop over groups mirrors."""
    # measured: 2.4e-7 (qwen2-tiny), 0 (starcoder2 smoke, bf16)
    r = ref(key)
    jm = JLM(dataclasses.replace(r.jcfg, scan_layers=False, remat="none"))
    want = jm.forward(r.qparams, {"tokens": jnp.asarray(r.tokens)})
    assert rel_l2(_fwd(_quantized_port(r), r.tokens), want) <= 1e-3


def test_greedy_generation_tokens_equal():
    """8 greedy tokens of qwen2-tiny (fp32): the reference's generate
    against the port's, from the same prompt."""
    r = ref("qwen2-tiny")
    prompt = r.tokens[:, :16]
    jtoks, _ = jserve.generate(r.jm, r.params, {"tokens": jnp.asarray(prompt)}, gen_len=8,
                               max_len=24)
    rec = serve.generate(r.port(), {"tokens": torch.from_numpy(prompt)}, gen_len=8, max_len=24)
    assert rec["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(rec["tokens"].numpy(), np.asarray(jtoks))


def _jax_teacher_forced(r, prompt, forced, max_len, ring=False):
    """JAX decode logits of each forced token after the prompt (a padded
    prefill cache), or from an empty cache (``ring``: init_cache, the local
    block a ring of its window)."""
    jm, p = r.jm, r.params
    if ring:
        cache, start = jm.init_cache(prompt.shape[0], max_len), 0
    else:
        _, cache = jm.forward(p, {"tokens": jnp.asarray(prompt)}, return_cache=True)
        cache, start = tp.jax_pad_cache(cache, prompt.shape[1], max_len), prompt.shape[1]
    out = []
    for i in range(forced.shape[1]):
        lg, cache = jm.decode_step(p, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])},
                                   jnp.int32(start + i))
        out.append(np.asarray(lg, np.float32))
    return out


@pytest.mark.parametrize("key,tol", [("starcoder2-smoke", 2e-2), ("qwen2-tiny", 1e-5)])
def test_teacher_forced_decode_logits(key, tol):
    # measured: worst step 8.4e-3 (starcoder2 smoke, bf16: the reference's decode
    # scans its layers under XLA's default excess precision), 4.1e-7 (qwen2-tiny)
    r = ref(key)
    prompt, forced = r.tokens[:, :24], r.tokens[:, 24:]
    want = _jax_teacher_forced(r, prompt, forced, 32)
    model = r.port()
    prefill, step = make_prefill(model), make_serve_step(model)
    last, cache = prefill({"tokens": torch.from_numpy(prompt)})
    cache = serve.pad_cache(cache, 24, 32)
    assert last.shape == (2, 1, r.tcfg.padded_vocab)
    worst = 0.0
    for i in range(forced.shape[1]):
        lg, cache = step(cache, {"tokens": torch.from_numpy(forced[:, i:i + 1])}, 24 + i)
        worst = max(worst, rel_l2(lg, want[i]))
    assert worst <= tol


def test_local_window_decode_past_the_ring():
    """From an empty cache, 20 decode steps through a local block whose ring
    holds 8 slots (and a global block and a tail beside it), each step's
    logits against the reference's."""
    r = ref("local")
    forced = np.random.default_rng(3).integers(0, 512, (2, 20)).astype(np.int32)
    want = _jax_teacher_forced(r, forced[:, :0], forced, 24, ring=True)
    model = r.port()
    cache = model.init_cache(2, 24)
    assert cache["groups"]["b1"]["k"].shape[2] == 8  # the local block's ring
    assert cache["groups"]["b0"]["k"].shape[2] == 24 and "t0" in cache["tail"]
    worst = 0.0
    with torch.no_grad():
        for i in range(forced.shape[1]):
            lg, cache = model.decode_step(cache, torch.from_numpy(forced[:, i:i + 1]), i)
            worst = max(worst, rel_l2(lg, want[i]))
    # measured: 4.0e-7
    assert worst <= 1e-5


def test_prefill_step_returns_last_position_and_cache():
    r = ref("qwen2-tiny")
    model = r.port()
    last, cache = make_prefill(model)({"tokens": torch.from_numpy(r.tokens)})
    full = _fwd(model, r.tokens)
    assert torch.equal(last, full[:, -1:])
    assert cache["groups"]["b0"]["k"].shape == (2, 2, 32, 2, 32)  # (groups, B, S, kv, hd)


# ----------------------------------------------------------------- plan


@pytest.mark.parametrize("key", ["qwen2-tiny", "starcoder2-smoke", "local"])
def test_plan_equals_the_unplanned_forward_bit_for_bit(key):
    r = ref(key)
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    model.quantize(stats)
    plan = model.plan(batch=2, seq=32)
    jplan = r.jm.plan(r.qparams, batch=2, seq=32, tune="off")
    assert [l.name for l in plan.layers] == [l.name for l in jplan.layers]
    assert plan.sample_spec == ((32,), "int32")
    tokens = torch.from_numpy(r.tokens)
    with torch.no_grad():
        got = plan(tokens)
        assert torch.equal(got, model.forward(tokens))
    assert plan.trace_count == 1
    plan.check(model.state())
    with torch.no_grad():  # the CPU's 'search' stages the rules' choices: the same bits
        assert torch.equal(model.plan(batch=2, seq=32, tune="search")(tokens), got)
    with pytest.raises(ValueError, match="tune"):
        model.plan(batch=2, seq=32, tune="fast")


def test_plan_needs_calibrated_scales():
    r = ref("qwen2-tiny")
    model = r.port()
    model.quantize()  # dynamic: no _aq siblings
    with pytest.raises(ValueError, match="calibrated"):
        model.plan(batch=2, seq=32)


# -------------------------------------------------------------- fixture


@pytest.fixture(scope="module")
def golden():
    with np.load(tp.FIXTURE_LM) as z:
        return unflatten(z)


def test_lm_fixture_matches_the_reference_today(golden):
    live = tp.jax_lm_golden()
    flat_live, flat_file = flatten(live), flatten(golden)
    assert set(flat_live) == set(flat_file)
    for k, v in flat_live.items():
        np.testing.assert_array_equal(flat_file[k], v, err_msg=k)
    assert tp.FIXTURE_LM.stat().st_size < 1 << 20


def test_port_on_the_lm_fixture(golden):
    """What chip_smoke.py holds on the card, here on the plain versions."""
    model = LM(get_config("qwen2-tiny")).load_params(params_from_numpy(golden["params"], "cpu"))
    tokens = torch.from_numpy(golden["tokens"])
    rec = serve.generate(model, {"tokens": tokens}, gen_len=2, max_len=33, keep=(0,))
    np.testing.assert_array_equal(rec["tokens"][:, :1].numpy(), golden["next"])
    # measured: 3.7e-7 and 3.9e-7
    assert rel_l2(_fwd(model, golden["tokens"])[:, -1:], golden["prefill"]) <= 1e-5
    assert rel_l2(rec["logits"][0], golden["decode"]) <= 1e-5
    stats = [ActStats(name=str(n), absmax=float(a))
             for n, a in zip(golden["stats"]["names"], golden["stats"]["absmax"])]
    model.quantize(stats)
    # measured: 0 (the fixture's stats give JAX's scales exactly)
    assert rel_l2(_fwd(model, golden["tokens"])[:, -1:], golden["quant"]) <= 1e-3


# ------------------------------------------------------------ plumbing


def test_stacked_weights_slice_to_their_group():
    w = torch.randn(3, 64, 24, generator=torch.Generator().manual_seed(0))
    fmt = DBBFormat(8, 3, "matrix")
    stacked = dbb_encode(w, fmt, prune=True)
    assert stacked.values.shape == (3, 8, 3, 24) and stacked.shape == (64, 24)
    from repro_torch.core.quant import quantize_dbb

    qs = quantize_dbb(stacked)
    assert qs.scales.shape == (3, 24)
    for g in range(3):
        one = dbb_encode(w[g], fmt, prune=True)
        assert torch.equal(stacked[g].values, one.values)
        assert torch.equal(stacked[g].indices, one.indices)
        q1 = quantize_dbb(one)
        assert torch.equal(qs[g].values, q1.values) and torch.equal(qs[g].scales, q1.scales)
    assert stacked.nbytes_compressed() == sum(stacked[g].nbytes_compressed() for g in range(3))


def test_bf16_leaves_cross_as_bits():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    tree = {"a": tp.to_numpy({"w": x})}
    back = params_from_numpy(unflatten(flatten(tree)), "cpu")["a"]["w"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(x, np.float32))


def test_per_column_weight_raises():
    w = dbb_encode(torch.randn(16, 8), DBBFormat(8, 3, None), prune=True)
    with pytest.raises(NotImplementedError, match="per-column"):
        apply_linear(torch.randn(2, 16), w)


def test_make_batch_is_seeded_int32_tokens():
    cfg = get_config("qwen2-tiny")
    a = make_batch(cfg, batch=2, seq=5, generator=torch.Generator().manual_seed(1))
    b = make_batch(cfg, batch=2, seq=5, generator=torch.Generator().manual_seed(1), kind="train")
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (2, 5)
    assert torch.equal(a["tokens"], b["tokens"]) and set(b) == {"tokens", "labels", "loss_mask"}
    assert int(a["tokens"].max()) < cfg.vocab_size


def test_init_compressed_leaf_by_leaf_equals_init_then_compress():
    cfg = smoke_config("starcoder2-7b")
    a = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
    b = LM(cfg).init(torch.Generator().manual_seed(0), "cpu").compress()
    for k, va in flatten_state(a.state()).items():
        assert torch.equal(va, flatten_state(b.state())[k]), k
    assert a.state()["embed"].dtype == torch.bfloat16


def flatten_state(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_state(v, f"{prefix}{k}/"))
        elif isinstance(v, (DBBWeight, QuantDBBWeight)):
            out[f"{prefix}{k}/values"], out[f"{prefix}{k}/indices"] = v.values, v.indices
        else:
            out[prefix + k] = v
    return out


def test_lm_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_lm("qwen2-tiny", gen=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_lm_plan("qwen2-tiny")


@pytest.mark.parametrize("extra,expect", [
    ([], "decode steps/s"),
    (["--lm-plan"], "bit-identical: True"),
    (["--smoke", "--arch", "starcoder2-7b", "--gen", "3"], "generated (4, 3) tokens"),
])
def test_cli_runs_on_the_cpu(extra, expect):
    args = ["--arch", "qwen2-tiny", "--device", "cpu", "--steps", "1"] + extra
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
