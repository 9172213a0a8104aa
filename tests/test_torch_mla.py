"""repro_torch's multi-head latent attention held against the JAX reference
on the CPU: ``MLAttention`` (the q LoRA, the latent cache, the full-sequence
forward and the absorbed decode, dense and compressed), the MLA ``LM``
(``deepseek-v3-671b``'s smoke config: 2 layers, 4 heads, ranks 32, 8
routed experts, top-2, one shared) through its forward, decode step,
calibration, INT8 quantization and frozen plan, ``generate`` at a prompt as
long as the batch, the golden fixture the card reads, and ``serve_lm``.

Parameters come from the JAX package (``torch_parity.to_numpy`` ->
``interop.params_from_numpy``); inputs from a numpy seed. JAX runs in ref
mode; the port runs its kernels' plain versions.

Tolerances, each with the value this file measured beside it:
  - defs, compressed values and indices, int8 codes, activation-stat names,
    greedy tokens (fp32), the plan against the unplanned forward, the
    decoded ``wkv_b`` against the reference's decode of it: equal;
  - the mixer in fp32 within 1e-6 relative L2, its bf16 within 2e-2 (it
    measured 0: eager JAX rounds each op where the port does);
  - the LM's fp32 outputs within 1e-5 relative L2, its bf16 within 2e-2,
    decode against the reference's unscanned decode (``test_torch_moe.py``
    says why);
  - the quantized forward within 5e-3 (the router's fp32 probabilities
    differ from XLA's by an ulp, as the MoE's).
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
from repro.core.quant import dequantize_dbb as jdequantize_dbb
from repro.core.vdbb import dbb_decode as jdbb_decode
from repro.launch import serve as jserve
from repro.models.attention import MLAttention as JMLA
from repro.models.common import Param as JParam
from repro.models.model import LM as JLM
from repro_torch.configs import registry as treg
from repro_torch.core.act_sparsity import ActStats
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBWeight
from repro_torch.interop import flatten, params_from_numpy, unflatten
from repro_torch.launch import serve
from repro_torch.models.attention import MLAttention
from repro_torch.models.common import dbb_leaves, param_leaves, tree_get, tree_slice
from repro_torch.models.model import LM, lm_defs
from repro_torch.models.plan import ModelPlan, PlanBuilder, params_fingerprint
from repro_torch.train.step import make_prefill, make_serve_step

ARCH = tp.MLA_ARCH


def rel_l2(a, b) -> float:
    def arr(x):
        return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)

    a, b = arr(a), arr(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fp32(mod, f32, **kw):
    return dataclasses.replace(mod.smoke_config(ARCH), param_dtype=f32, compute_dtype=f32, **kw)


CONFIGS = {
    "mla": (lambda: jreg.smoke_config(ARCH), lambda: treg.smoke_config(ARCH)),
    "mla-fp32": (lambda: _fp32(jreg, jnp.float32), lambda: _fp32(treg, torch.float32)),
    # a dense q projection (``wq``) instead of the q LoRA
    "mla-fp32-no-q-lora": (lambda: _fp32(jreg, jnp.float32, q_lora_rank=0),
                           lambda: _fp32(treg, torch.float32, q_lora_rank=0)),
}
TOL = {"mla": 2e-2, "mla-fp32": 1e-5, "mla-fp32-no-q-lora": 1e-5}
MIXER_TOL = {"mla": 2e-2, "mla-fp32": 1e-6, "mla-fp32-no-q-lora": 1e-6}


class Ref:
    """One config's JAX reference: dense and compressed params, tokens,
    prefill logits and cache, calibration stats, quantized params."""

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


def _unscanned(r):
    return JLM(dataclasses.replace(r.jcfg, scan_layers=False, remat="none"))


# ------------------------------------------------------------ the mixer


def _mixer_pair(key, compressed):
    """The reference's and the port's ``MLAttention`` with layer 0's mixer
    params of the config's LM, dense or compressed."""
    r = ref(key)
    tree = r.params if compressed else r.dense
    jp = jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["b0"]["mixer"])
    tp_ = tree_slice(params_from_numpy(tp.to_numpy(tree), "cpu")["layers"], 0)["b0"]["mixer"]
    return JMLA(r.jcfg), jp, MLAttention(r.tcfg), tp_, r.tcfg.compute_dtype


def _inputs(key, shape, seed=0):
    dt = CONFIGS[key][1]().compute_dtype
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(dt)


MIXER_CASES = [(k, c) for k in CONFIGS for c in (False, True)]
MIXER_IDS = [f"{k}-{'compressed' if c else 'dense'}" for k, c in MIXER_CASES]


@pytest.mark.parametrize("key,compressed", MIXER_CASES, ids=MIXER_IDS)
def test_mixer_forward_matches_reference(key, compressed):
    """The full-sequence forward (the q LoRA or ``wq``, the latent, K with
    ``k_rope`` broadcast to every head, 1/sqrt(192)-style scale) and the
    latent cache it returns."""
    # measured: fp32 1.3e-7 to 2.1e-7, bf16 0 (eager JAX rounds where the port does)
    jm, jp, tm, tp_, dt = _mixer_pair(key, compressed)
    xj, xt = _inputs(key, (2, 12, 128))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, wcache = jm(jp, xj, jnp.asarray(pos))
    with torch.no_grad():
        got, cache = tm(tp_, xt, torch.from_numpy(pos.astype(np.int64)))
    assert got.shape == tuple(want.shape) and got.dtype == dt
    assert rel_l2(got, np.asarray(want, np.float32)) <= MIXER_TOL[key]
    assert set(cache) == set(wcache) == {"c_kv", "k_rope"}
    for name in cache:
        assert cache[name].shape == tuple(wcache[name].shape)
        assert rel_l2(cache[name], np.asarray(wcache[name], np.float32)) <= MIXER_TOL[key]


@pytest.mark.parametrize("key,compressed", MIXER_CASES, ids=MIXER_IDS)
def test_absorbed_decode_matches_reference(key, compressed):
    """The absorbed decode fed token by token from an empty cache of 14
    slots (two never written, masked by ``slot <= pos``): each step's
    output and the latent cache at the end."""
    # measured: fp32 worst 2.1e-7 to 5.0e-7, bf16 0
    jm, jp, tm, tp_, dt = _mixer_pair(key, compressed)
    xj, xt = _inputs(key, (2, 12, 128), seed=1)
    jcache = jm.init_cache(2, 14, xj.dtype)
    cache = tm.init_cache(2, 14, dt)
    worst = 0.0
    with torch.no_grad():
        for i in range(12):
            want, jcache = jm.decode(jp, xj[:, i:i + 1], jcache, jnp.int32(i))
            got, cache = tm.decode(tp_, xt[:, i:i + 1], cache, torch.tensor(i))
            worst = max(worst, rel_l2(got, np.asarray(want, np.float32)))
    assert worst <= MIXER_TOL[key]
    for name in ("c_kv", "k_rope"):
        assert rel_l2(cache[name], np.asarray(jcache[name], np.float32)) <= MIXER_TOL[key]
        assert not cache[name][:, 12:].any()


@pytest.mark.parametrize("compressed", [False, True], ids=["dense", "compressed"])
@pytest.mark.parametrize("key", ["mla-fp32", "mla-fp32-no-q-lora"])
def test_port_decode_equals_its_forward(key, compressed):
    """The port's own mixer: its absorbed decode over the positions of a
    sequence against its full-sequence forward, in fp32. (Not on int8
    weights: there the forward quantizes ``c_kv`` into ``wkv_b`` while the
    absorbed decode contracts it in floating point with the dequantized
    weight, in the reference as here.)"""
    # measured: 1.3e-7 to 1.4e-7 (compressed), 3.9e-7 (dense)
    r = ref(key)
    model = r.port() if compressed else r.port(r.dense)
    p = tree_slice(model.state()["layers"], 0)["b0"]["mixer"]
    mla = MLAttention(r.tcfg)
    _, x = _inputs(key, (2, 12, 128), seed=2)
    with torch.no_grad():
        want, full = mla(p, x, torch.arange(12).expand(2, 12))
        cache = mla.init_cache(2, 12, torch.float32)
        got = torch.cat([mla.decode(p, x[:, i:i + 1], cache, torch.tensor(i))[0]
                         for i in range(12)], dim=1)
    assert rel_l2(got, want) <= 1e-6
    assert all(rel_l2(cache[k], full[k]) <= 1e-6 for k in ("c_kv", "k_rope"))


@pytest.mark.parametrize("quantized", [False, True], ids=["compressed", "int8"])
def test_decoded_wkv_b_is_the_references_bit_for_bit(quantized):
    """The model decodes each MLA block's ``wkv_b`` once, beside the tree:
    its (w_uk, w_uv) equal what the reference's decode step computes from
    the same leaf (``dequantize_dbb`` for an int8 one, ``dbb_decode``, the
    cast to the activation dtype), and the tree keeps the compressed leaf."""
    r = ref("mla")
    model = r.port()
    jparams = r.params
    if quantized:
        _, stats = _fwd(model, r.tokens, collect_act_stats=True)
        model.quantize(stats)
        jparams = r.qparams
    c = r.jcfg
    for g in range(c.num_groups):
        jw = jax.tree_util.tree_map(lambda a: a[g], jparams["layers"]["b0"]["mixer"]["wkv_b"])
        if quantized:
            jw = jdequantize_dbb(jw)
        want = jdbb_decode(jw).reshape(c.kv_lora_rank, c.num_heads,
                                       c.qk_nope_dim + c.v_head_dim).astype(jnp.bfloat16)
        w_uk, w_uv = model._absorbed["b0", g]
        assert w_uk.dtype == w_uv.dtype == torch.bfloat16
        np.testing.assert_array_equal(w_uk.float().numpy(),
                                      np.asarray(want[..., : c.qk_nope_dim], np.float32))
        np.testing.assert_array_equal(w_uv.float().numpy(),
                                      np.asarray(want[..., c.qk_nope_dim:], np.float32))
    leaf = model.state()["layers"]["b0"]["mixer"]["wkv_b"]
    assert isinstance(leaf, QuantDBBWeight if quantized else DBBWeight)


def test_decoded_wkv_b_follows_the_tree():
    """``load_params``, ``compress`` and ``quantize`` each decode ``wkv_b``
    anew, and the copy never enters the tree its fingerprint hashes."""
    r = ref("mla-fp32")
    model = r.port(r.dense)
    dense = model._absorbed["b0", 0][0].clone()
    fp = params_fingerprint(model.state())
    model.compress()
    assert not torch.equal(model._absorbed["b0", 0][0], dense)  # pruned since
    assert params_fingerprint(model.state()) != fp
    compressed = model._absorbed["b0", 0][0].clone()
    model.quantize()
    assert not torch.equal(model._absorbed["b0", 0][0], compressed)  # int8 round trip

    def paths(tree, prefix=()):
        for k, v in tree.items():
            yield from paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)]

    assert set(paths(model.state())) == {path for path, _ in param_leaves(model.defs())}
    assert LM(treg.smoke_config("qwen2-tiny"))._absorbed == {}


# ----------------------------------------------------- defs and counts


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("q_lora", [True, False], ids=["q-lora", "wq"])
def test_defs_paths_shapes_and_param_count(smoke, q_lora):
    j = (jreg.smoke_config if smoke else jreg.get_config)(ARCH)
    t = (treg.smoke_config if smoke else treg.get_config)(ARCH)
    if not q_lora:
        j, t = dataclasses.replace(j, q_lora_rank=0), dataclasses.replace(t, q_lora_rank=0)
    flat, _ = jax.tree_util.tree_flatten_with_path(JLM(j).defs(),
                                                   is_leaf=lambda x: isinstance(x, JParam))
    jl = {tuple(k.key for k in path): p for path, p in flat}
    tl = dict(param_leaves(LM(t).defs()))
    assert set(tl) == set(jl)
    mixer = {path[3] for path in tl if path[2:3] == ("mixer",)}
    assert mixer == ({"wq_a", "q_norm", "wq_b"} if q_lora else {"wq"}) | {
        "wkv_a", "kv_norm", "wkv_b", "wo"}
    for path, p in tl.items():
        q = jl[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
        assert (p.dbb is None) == (q.dbb is None), path
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_full_size_counts():
    """703.80 B weights, 37.56 B of them active a token; the two-layer cut
    the card runs holds 24.87 B."""
    cfg = treg.get_config(ARCH)
    assert cfg.param_count() == 703_797_812_224
    assert cfg.active_param_count() == 37_557_787_648
    assert dataclasses.replace(cfg, num_layers=2).param_count() == 24_867_937_280


def test_lm_defs_names_the_frontends_leaves_the_lm_refuses():
    """``lm_defs`` describes a cross-attention block and the audio
    codebooks; ``LM`` now builds both frontends' models (item 12e), at full
    and at smoke size, on exactly those defs."""
    tl = dict(param_leaves(lm_defs(treg.get_config("musicgen-medium"))))
    assert ("layers", "b0", "cross", "wq") in tl and ("layers", "b0", "norm_x", "g") in tl
    assert tl[("embed",)].shape == (4, 2048, 1536)
    for arch in ("musicgen-medium", "internvl2-2b"):
        for cfg in (treg.get_config(arch), treg.smoke_config(arch)):
            model = LM(cfg)
            assert dict(param_leaves(model.defs())) == dict(param_leaves(lm_defs(cfg)))


# ------------------------------------------------------------ the LM


@pytest.mark.parametrize("key", list(CONFIGS))
def test_prefill_logits_and_latent_cache(key):
    # measured: bf16 2.5e-5, fp32 5.7e-7 and 6.5e-7
    r = ref(key)
    logits, cache = _fwd(r.port(), r.tokens, return_cache=True)
    assert logits.shape == tuple(r.logits.shape) and logits.dtype == r.tcfg.compute_dtype
    assert rel_l2(logits, r.logits) <= TOL[key]
    for name in ("c_kv", "k_rope"):
        want = np.asarray(r.cache["groups"]["b0"][name], np.float32)
        assert cache["groups"]["b0"][name].shape == want.shape
        assert rel_l2(cache["groups"]["b0"][name], want) <= TOL[key]


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


@pytest.mark.parametrize("key", list(CONFIGS))
def test_teacher_forced_decode_logits(key):
    """Absorbed decode steps after a prefill whose latent cache
    ``pad_cache`` padded, each step's logits against the reference's."""
    # measured: worst step bf16 8.2e-4, fp32 8.6e-7
    r = ref(key)
    prompt, forced = r.tokens[:, :24], r.tokens[:, 24:]
    want = _jax_teacher_forced(r, prompt, forced, 32)
    model = r.port()
    _, cache = make_prefill(model)({"tokens": torch.from_numpy(prompt)})
    cache = serve.pad_cache(cache, 24, 32)
    step = make_serve_step(model)
    worst = 0.0
    for i in range(forced.shape[1]):
        lg, cache = step(cache, {"tokens": torch.from_numpy(forced[:, i:i + 1])},
                         torch.tensor(24 + i))
        worst = max(worst, rel_l2(lg, want[i]))
    assert worst <= TOL[key]


def test_generate_at_a_prompt_as_long_as_the_batch():
    """B = S = 4: the reference's ``pad_to_cap`` pads the stacked
    (G, B, S, r) ``c_kv`` on its batch axis there, and its generate fails
    (ROADMAP queue 3); the port pads by key. Its greedy tokens equal the
    reference's decode fed the same tokens after a cache padded by key."""
    r = ref("mla-fp32")
    prompt = np.random.default_rng(4).integers(0, r.jcfg.vocab_size, (4, 4)).astype(np.int32)
    rec = serve.generate(r.port(), {"tokens": torch.from_numpy(prompt)}, gen_len=6,
                         max_len=10, keep=(0, 4))
    toks = rec["tokens"].numpy()
    want = _jax_teacher_forced(r, prompt, toks[:, :5], 10)
    for i in range(5):
        np.testing.assert_array_equal(want[i].argmax(-1), toks[:, i + 1:i + 2])
    # measured: 5.8e-7
    assert rel_l2(rec["logits"][0], want[0]) <= 1e-5 and rel_l2(rec["logits"][4], want[4]) <= 1e-5
    with pytest.raises(Exception):
        jserve.generate(r.jm, r.params, {"tokens": jnp.asarray(prompt)}, gen_len=6, max_len=10)


def test_greedy_generation_tokens_equal():
    """8 greedy tokens of the fp32 MLA MoE: the reference's generate
    against the port's, compiled (the default) and eager. The prompt is 12
    tokens: at 16, the smoke config's ``qk_rope_dim``, the reference's
    ``pad_to_cap`` leaves the (…, S, 16) ``k_rope`` unpadded (it skips a
    leaf whose last axis equals the prompt length) and its decode fails."""
    r = ref("mla-fp32")
    prompt = r.tokens[:, :12]
    jtoks, _ = jserve.generate(r.jm, r.params, {"tokens": jnp.asarray(prompt)}, gen_len=8,
                               max_len=20)
    recs = {g: serve.generate(r.port(), {"tokens": torch.from_numpy(prompt)}, gen_len=8,
                              max_len=20, keep=(0, 6), graph=g) for g in (True, False)}
    for rec in recs.values():
        np.testing.assert_array_equal(rec["tokens"].numpy(), np.asarray(jtoks))
    assert recs[True]["captures"] == 2 and recs[False]["captures"] == 0
    assert all(torch.equal(recs[True]["logits"][i], recs[False]["logits"][i]) for i in (0, 6))


def test_pad_cache_pads_the_latent_cache_on_its_sequence_axis():
    """``c_kv`` (G, B, S, r) and ``k_rope`` (G, B, S, p) at B = S = plen get
    plen slots of max_len on axis -2, never the batch axis; ``restore_state``
    leaves them to the step."""
    plen, max_len = 4, 9
    ckv, krp = torch.randn(2, plen, plen, 32), torch.randn(2, plen, plen, 16)
    cache = {"groups": {"b0": {"c_kv": ckv, "k_rope": krp}}}
    out = serve.pad_cache(cache, plen, max_len)
    for name, v in cache["groups"]["b0"].items():
        got = out["groups"]["b0"][name]
        assert got.shape == (2, plen, max_len, v.shape[-1])
        assert torch.equal(got[:, :, :plen], v) and not got[:, :, plen:].any()
    got = out["groups"]["b0"]["c_kv"]
    got[:, :, plen:] = 1.0
    serve.restore_state(out, cache)
    assert bool((got[:, :, plen:] == 1.0).all())


def test_act_stat_names_and_quantize():
    """Calibration records each MLA projection's input under the block's
    ``mixer`` scope (``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``wo``) as
    the reference does; quantize gives its int8 codes and act scales."""
    r = ref("mla")
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    names = {s.name for s in stats}
    assert names == {s.name for s in r.stats}
    assert {f"g0.b0.mixer.{n}" for n in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")} <= names
    model.quantize(stats)
    for path, _ in dbb_leaves(model.defs()):
        jq, tq = tree_get(r.qparams, path), tree_get(model.state(), path)
        assert isinstance(tq, QuantDBBWeight)
        np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
        aq = path[:-1] + (path[-1] + "_aq",)
        # measured: 0
        np.testing.assert_allclose(tree_get(model.state(), aq).numpy(),
                                   np.asarray(tree_get(r.qparams, aq)), rtol=1e-5)
    assert "wkv_b_aq" in model.state()["layers"]["b0"]["mixer"]


def test_quantized_forward_and_plan():
    """The INT8 MLA MoE: its forward against the reference's unscanned
    forward, and the frozen plan (every MLA projection staged with its
    calibrated scale) equal to the unplanned forward bit for bit."""
    r = ref("mla")
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    model.quantize(stats)
    want = _unscanned(r).forward(r.qparams, {"tokens": jnp.asarray(r.tokens)})
    got = _fwd(model, r.tokens)
    # measured: 3.5e-4
    assert rel_l2(got, want) <= 5e-3
    plan = model.plan(batch=2, seq=32)
    jplan = r.jm.plan(r.qparams, batch=2, seq=32, tune="off")
    assert [l.name for l in plan.layers] == [l.name for l in jplan.layers]
    with torch.no_grad():
        assert torch.equal(plan(torch.from_numpy(r.tokens)), got)
    assert plan.trace_count == 1


def test_plan_stages_mla_with_calibrated_scales():
    """The staged MLA projections freeze their calibrated act scales in:
    none is dynamic, and a model quantized without stats (no ``_aq``)
    cannot be planned."""
    r = ref("mla")
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    model.quantize(stats)
    staged = model._staged_block("attn", tree_slice(model.state()["layers"], 0)["b0"], 64)
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        assert staged["mixer"][name].quantized, name
    bare = r.port()
    bare.quantize()
    with pytest.raises(ValueError):
        bare.plan(batch=2, seq=32)


# ---------------------------------------------------------- the plan device


def test_a_plan_needs_its_device():
    """``PlanBuilder`` and ``ModelPlan`` take no default device: a plan
    left to assume the CPU around card tensors would replay nothing."""
    r = ref("mla")
    with pytest.raises(TypeError):
        PlanBuilder("m", r.port().state(), batch=1)
    with pytest.raises(ValueError, match="device"):
        ModelPlan("m", "fp", ())


def test_a_plan_of_card_less_params_runs_on_the_cpu():
    """Params that never saw a card, planned with ``device='cpu'`` passed:
    the chain runs eagerly on the plain versions and equals the unplanned
    forward."""
    r = ref("mla")
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    model.quantize(stats)
    pb = PlanBuilder("mla", model.state(), batch=2, sample_spec=((32,), "int32"), device="cpu")
    pb.raw("all", "lm", lambda t: model.forward(t))
    plan = pb.build()
    assert plan.device == torch.device("cpu") and plan.pool is None
    with torch.no_grad():
        assert torch.equal(plan(torch.from_numpy(r.tokens)), _fwd(model, r.tokens))


# -------------------------------------------------------------- fixture


@pytest.fixture(scope="module")
def golden():
    with np.load(tp.FIXTURE_MLA) as z:
        return unflatten(z)


def test_mla_fixture_matches_the_reference_today(golden):
    live, flat_file = flatten(tp.jax_mla_golden()), flatten(golden)
    assert set(live) == set(flat_file)
    for k, v in live.items():
        np.testing.assert_array_equal(flat_file[k], v, err_msg=k)
    assert tp.FIXTURE_MLA.stat().st_size < 1 << 20
    assert set(golden["params"]["layers"]["b0"]["mlp"]["we_up"]) == {"seed", "shape", "std"}


def test_port_on_the_mla_fixture(golden):
    """What chip_smoke.py phase 10c holds on the card, here on the plain
    versions: the next token equal, prefill and decode logits within 1e-5,
    the quantized forward within 1e-5 as well."""
    model = LM(_fp32(treg, torch.float32)).load_params(params_from_numpy(golden["params"], "cpu"))
    tokens = torch.from_numpy(golden["tokens"])
    rec = serve.generate(model, {"tokens": tokens}, gen_len=2, max_len=tokens.shape[1] + 1,
                         keep=(0,))
    np.testing.assert_array_equal(rec["tokens"][:, :1].numpy(), golden["next"])
    # measured: 7.5e-7, 8.7e-7 and 5.4e-7
    assert rel_l2(_fwd(model, golden["tokens"])[:, -1:], golden["prefill"]) <= 1e-5
    assert rel_l2(rec["logits"][0], golden["decode"]) <= 1e-5
    model.quantize([ActStats(name=str(n), absmax=float(a))
                    for n, a in zip(golden["stats"]["names"], golden["stats"]["absmax"])])
    assert rel_l2(_fwd(model, golden["tokens"])[:, -1:], golden["quant"]) <= 1e-5


# ------------------------------------------------------------ serve_lm


@pytest.mark.parametrize("dense", [False, True], ids=["compressed", "dense"])
def test_serve_lm_on_the_cpu(dense):
    """``serve_lm`` at the smoke config on the CPU, by name and by a
    ``ModelConfig`` (a depth cut of the same arch, as the card's run)."""
    logs = []
    rec = serve.serve_lm(ARCH, batch=2, prompt_len=8, gen=4, device="cpu", smoke=True,
                         dense=dense, log=logs.append)
    assert rec["tokens"].shape == (2, 4) and rec["captures"] == 2
    assert ("VDBB-compressed" in logs[0]) != dense
    cfg = dataclasses.replace(treg.smoke_config(ARCH), num_layers=1)
    one = serve.serve_lm(cfg, batch=2, prompt_len=8, gen=4, device="cpu", dense=dense,
                         log=logs.append)
    assert one["model"].cfg.num_layers == 1 and (one["model"].cfg.dbb is None) == dense
    assert one["tokens"].shape == (2, 4)


def test_serve_lm_plan_on_the_cpu():
    rec = serve.serve_lm_plan(ARCH, batch=2, prompt_len=8, steps=1, device="cpu", smoke=True,
                              log=lambda *_: None)
    assert rec["bit_identical"] and rec["captures"] == 1
