"""repro_torch's cross-attention and modality frontends held against the JAX
reference on the CPU: ``GQAttention(cross=True)`` (K/V from an encoder
memory, no RoPE, no mask; decode reads the memory's K/V from the cache),
the audio LM (``musicgen-medium``'s smoke config: 2 layers, 4 codebooks of
2048, cross-attention to a 16-slot memory, LayerNorm, GELU) and the vision
LM (``internvl2-2b``'s: 8 vision embeddings over the first positions,
RMSNorm, SwiGLU, 2 KV heads), through their forward, decode step,
calibration, INT8 quantization, ``generate`` (audio tokens fed to every
codebook; a prompt as long as the memory), ``make_batch``, the plan's
refusal, ``serve_lm`` and the golden fixtures the card reads.

Parameters come from the JAX package (``torch_parity.to_numpy`` ->
``interop.params_from_numpy``); tokens and side inputs from a numpy seed
(``torch_parity.side_batch``). JAX runs in ref mode; the port runs its
kernels' plain versions.

Tolerances, each with the value this file measured beside it:
  - defs, int8 codes, activation-stat names, greedy tokens, the cross K/V
    the decode leaves in the cache: equal;
  - fp32 logits and cache leaves within 1e-6 relative L2 (summation
    order), the mixer in fp32 within 1e-6;
  - bf16 within 2e-2 (``test_torch_lm.py``'s GQA tolerance), decode
    against the reference's unscanned decode;
  - the quantized forward within 1e-3, against the reference's unscanned
    forward (``test_torch_lm.py`` says why).
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
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import registry as jreg
from repro.configs.shapes import make_batch as jmake_batch
from repro.launch import serve as jserve
from repro.models.attention import GQAttention as JGQA
from repro.models.common import Param as JParam
from repro.models.model import LM as JLM
from repro_torch.configs import make_batch
from repro_torch.configs import registry as treg
from repro_torch.core.act_sparsity import ActStats
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.interop import flatten, params_from_numpy, unflatten
from repro_torch.launch import serve
from repro_torch.models.attention import GQAttention
from repro_torch.models.common import dbb_leaves, param_leaves, tree_get, tree_slice
from repro_torch.models.model import LM
from repro_torch.train.step import make_prefill, make_serve_step

AUDIO, VLM = tp.AUDIO_ARCH, tp.VLM_ARCH
ROOT = Path(__file__).resolve().parents[1]


def rel_l2(a, b) -> float:
    def arr(x):
        return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)

    a, b = arr(a), arr(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfgs(arch, fp32=False, **kw):
    def j():
        c = jreg.smoke_config(arch)
        if fp32:
            c = dataclasses.replace(c, param_dtype=jnp.float32, compute_dtype=jnp.float32)
        return dataclasses.replace(c, **kw)

    def t():
        c = treg.smoke_config(arch)
        if fp32:
            c = dataclasses.replace(c, param_dtype=torch.float32, compute_dtype=torch.float32)
        return dataclasses.replace(c, **kw)

    return j, t


CONFIGS = {
    "audio": _cfgs(AUDIO),
    "audio-fp32": _cfgs(AUDIO, fp32=True),
    "vlm": _cfgs(VLM),
    "vlm-fp32": _cfgs(VLM, fp32=True),
}
TOL = {"audio": 2e-2, "audio-fp32": 1e-6, "vlm": 2e-2, "vlm-fp32": 1e-6}
# the mixer alone, and with grouped K/V (2 KV heads for 4 query heads)
MIXER_CONFIGS = {"audio": CONFIGS["audio"], "audio-fp32": CONFIGS["audio-fp32"],
                 "audio-fp32-gqa": _cfgs(AUDIO, fp32=True, num_kv_heads=2)}
MIXER_TOL = {"audio": 2e-2, "audio-fp32": 1e-6, "audio-fp32-gqa": 1e-6}


class Ref:
    """One config's JAX reference: dense and compressed params, a prompt
    batch with its side inputs, prefill logits and cache, calibration
    stats, quantized params."""

    def __init__(self, key, seed=0, batch=2, seq=32):
        jcfg, tcfg = CONFIGS[key]
        self.key, self.jcfg, self.tcfg = key, jcfg(), tcfg()
        self.jm = JLM(self.jcfg)
        self.dense = self.jm.init(jax.random.PRNGKey(seed))
        self.params = self.jm.compress(self.dense)
        self.inputs = tp.side_batch(self.jcfg, seed, batch, seq)
        self.tokens = self.inputs["tokens"]
        self.logits, self.cache, self.stats = self.jm.forward(
            self.params, self.jbatch(), return_cache=True, collect_act_stats=True)
        self.qparams = self.jm.quantize(self.params, self.stats)

    def jbatch(self, tokens=None):
        out = {k: jnp.asarray(v) for k, v in self.inputs.items()}
        if tokens is not None:
            out["tokens"] = jnp.asarray(tokens)
        return out

    def side(self) -> dict:
        """The side inputs as the port takes them (bf16 values, as
        ``make_batch`` draws them)."""
        return {k: torch.from_numpy(np.array(v)).bfloat16() for k, v in self.inputs.items()
                if k != "tokens"}

    def port(self, tree=None) -> LM:
        return LM(self.tcfg).load_params(
            params_from_numpy(tp.to_numpy(self.params if tree is None else tree), "cpu"))


_REFS = {}


def ref(key) -> Ref:
    if key not in _REFS:
        _REFS[key] = Ref(key)
    return _REFS[key]


def _fwd(model, r, tokens=None, **kw):
    with torch.no_grad():
        return model.forward(torch.from_numpy(r.tokens if tokens is None else tokens),
                             **r.side(), **kw)


def _unscanned(r):
    return JLM(dataclasses.replace(r.jcfg, scan_layers=False, remat="none"))


# ------------------------------------------------------- the cross mixer


def _mixer_pair(key, compressed):
    """The reference's and the port's cross ``GQAttention`` with layer 0's
    ``cross`` params of the config's LM, dense or compressed."""
    j, t = MIXER_CONFIGS[key]
    jcfg, tcfg = j(), t()
    jm = JLM(jcfg)
    dense = jm.init(jax.random.PRNGKey(1))
    tree = jm.compress(dense) if compressed else dense
    jp = jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["b0"]["cross"])
    tp_ = tree_slice(params_from_numpy(tp.to_numpy(tree), "cpu")["layers"], 0)["b0"]["cross"]
    return JGQA(jcfg, cross=True), jp, GQAttention(tcfg, cross=True), tp_, tcfg


def _inputs(dt, shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dt)


MIXER_CASES = [(k, c) for k in MIXER_CONFIGS for c in (False, True)]
MIXER_IDS = [f"{k}-{'compressed' if c else 'dense'}" for k, c in MIXER_CASES]


@pytest.mark.parametrize("key,compressed", MIXER_CASES, ids=MIXER_IDS)
def test_cross_mixer_forward_matches_reference(key, compressed):
    """Q from x, K/V from the memory (16 slots for 12 queries), no RoPE,
    every pair attended; the cache keeps the compact K/V of the memory."""
    # measured: fp32 1.9e-7 to 2.7e-7, bf16 0 to 1.5e-4; the cache fp32 and bf16 0
    jm, jp, tm, tp_, cfg = _mixer_pair(key, compressed)
    dt = cfg.compute_dtype
    xj, xt = _inputs(dt, (2, 12, 128))
    mj, mt = _inputs(dt, (2, cfg.cross_len, 128), seed=1)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, wcache = jm(jp, xj, jnp.asarray(pos), memory=mj)
    with torch.no_grad():
        got, cache = tm(tp_, xt, torch.from_numpy(pos.astype(np.int64)), memory=mt)
    assert got.shape == tuple(want.shape) and got.dtype == dt
    assert rel_l2(got, np.asarray(want, np.float32)) <= MIXER_TOL[key]
    assert set(cache) == set(wcache) == {"k", "v"}
    for name in cache:
        assert cache[name].shape == tuple(wcache[name].shape) == (2, cfg.cross_len,
                                                                  cfg.num_kv_heads, cfg.hd)
        assert rel_l2(cache[name], np.asarray(wcache[name], np.float32)) <= MIXER_TOL[key]


@pytest.mark.parametrize("key,compressed", MIXER_CASES, ids=MIXER_IDS)
def test_cross_mixer_decode_reads_the_cache(key, compressed):
    """Decode from the memory's cached K/V, token by token at any position:
    each step equals the reference's, the cache is never written, and the
    steps equal the full-sequence forward's rows (no position enters)."""
    # measured: fp32 worst 3.5e-7, bf16 0
    jm, jp, tm, tp_, cfg = _mixer_pair(key, compressed)
    dt = cfg.compute_dtype
    xj, xt = _inputs(dt, (2, 6, 128), seed=2)
    mj, mt = _inputs(dt, (2, cfg.cross_len, 128), seed=3)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    _, jcache = jm(jp, xj, jnp.asarray(pos), memory=mj)
    with torch.no_grad():
        full, cache = tm(tp_, xt, torch.from_numpy(pos.astype(np.int64)), memory=mt)
        kept = {k: v.clone() for k, v in cache.items()}
        for i in range(6):
            want, _ = jm.decode(jp, xj[:, i:i + 1], jcache, jnp.int32(40 + i))
            got, out = tm.decode(tp_, xt[:, i:i + 1], cache, torch.tensor(40 + i))
            assert out is cache
            assert rel_l2(got, np.asarray(want, np.float32)) <= MIXER_TOL[key]
            assert rel_l2(got, full[:, i:i + 1]) <= MIXER_TOL[key]
    assert all(torch.equal(cache[k], kept[k]) for k in kept)


def test_cross_init_cache_holds_the_memory_slots():
    cfg = treg.smoke_config(AUDIO)
    cache = GQAttention(cfg, cross=True).init_cache(3, 100, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (3, cfg.cross_len, cfg.num_kv_heads, cfg.hd),
        "v": (3, cfg.cross_len, cfg.num_kv_heads, cfg.hd)}


# ---------------------------------------------------- defs and the build


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_defs_paths_shapes_and_param_count(arch, smoke):
    j = (jreg.smoke_config if smoke else jreg.get_config)(arch)
    t = (treg.smoke_config if smoke else treg.get_config)(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(JLM(j).defs(),
                                                   is_leaf=lambda x: isinstance(x, JParam))
    jl = {tuple(k.key for k in path): p for path, p in flat}
    model = LM(t)
    tl = dict(param_leaves(model.defs()))
    assert set(tl) == set(jl)
    for path, p in tl.items():
        q = jl[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
        assert (p.dbb is None) == (q.dbb is None), path
    assert t.param_count() == j.param_count()
    assert (("layers", "b0", "cross", "wk") in tl) == (arch == AUDIO)


def test_full_size_counts():
    """Both fit one card at full width and depth."""
    assert treg.get_config(AUDIO).param_count() == 1_837_550_592
    assert treg.get_config(VLM).param_count() == 1_889_634_304


# ------------------------------------------------------------ the LM


def _cache_leaves(cache, prefix=()):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("key", list(CONFIGS))
def test_prefill_logits_and_every_cache_leaf(key):
    """The forward fed the side inputs: logits, and every cache leaf (a
    cross block's ``self`` and ``cross`` K/V) against the reference's."""
    # measured: fp32 logits 4.0e-7 (audio), 4.4e-7 (vlm), self K/V 2.6e-7 to 2.9e-7, cross
    # K/V 0; bf16 logits 1.6e-5 (audio), 3.1e-9 (vlm), every cache leaf 0
    r = ref(key)
    logits, cache = _fwd(r.port(), r, return_cache=True)
    assert logits.shape == tuple(r.logits.shape) and logits.dtype == r.tcfg.compute_dtype
    assert rel_l2(logits, r.logits) <= TOL[key]
    want = dict(_cache_leaves(jax.tree_util.tree_map(np.asarray, r.cache)))
    got = dict(_cache_leaves(cache))
    assert set(got) == set(want)
    if r.tcfg.cross_attn:
        assert ("groups", "b0", "cross", "k") in got
        assert got["groups", "b0", "cross", "k"].shape[2] == r.tcfg.cross_len
    for path, v in got.items():
        assert v.shape == want[path].shape, path
        assert rel_l2(v, np.asarray(want[path], np.float32)) <= TOL[key], path


def _jax_teacher_forced(r, prompt, forced, max_len):
    """The reference's decode logits of each forced token after the prompt
    (its side inputs fed to the prefill), the cache padded by key with the
    cross K/V as they are (``torch_parity.jax_pad_cache``)."""
    jm, p = _unscanned(r), r.params
    _, cache = jm.forward(p, r.jbatch(prompt), return_cache=True)
    cache = tp.jax_pad_cache(cache, prompt.shape[1], max_len)
    out = []
    for i in range(forced.shape[1]):
        lg, cache = jm.decode_step(p, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])},
                                   jnp.int32(prompt.shape[1] + i))
        out.append(np.asarray(lg, np.float32))
    return out


@pytest.mark.parametrize("key", list(CONFIGS))
def test_teacher_forced_decode_logits(key):
    """Decode steps after a prefill whose cache ``pad_cache`` padded (the
    cross K/V left at the memory's 16 slots), each step's logits against
    the reference's; the steps read no memory."""
    # measured: worst step fp32 4.3e-7 (audio), 5.0e-7 (vlm); bf16 3.5e-5, 0
    r = ref(key)
    prompt, forced = r.tokens[:, :24], r.tokens[:, 24:]
    want = _jax_teacher_forced(r, prompt, forced, 32)
    model = r.port()
    _, cache = make_prefill(model)({"tokens": torch.from_numpy(prompt), **r.side()})
    cache = serve.pad_cache(cache, 24, 32)
    step = make_serve_step(model)
    worst = 0.0
    for i in range(forced.shape[1]):
        lg, cache = step(cache, {"tokens": torch.from_numpy(forced[:, i:i + 1])},
                         torch.tensor(24 + i))
        worst = max(worst, rel_l2(lg, want[i]))
    assert worst <= TOL[key]


@pytest.mark.parametrize("key", ["audio-fp32", "vlm-fp32"])
def test_greedy_generation_tokens_equal(key):
    """8 greedy tokens: the reference's generate against the port's,
    through its graphs' path (the default) and eagerly; audio tokens are
    (B, 8, 4), each step's argmax within a codebook fed to all four."""
    r = ref(key)
    prompt = r.tokens[:, :12]
    jtoks, _ = jserve.generate(r.jm, r.params, r.jbatch(prompt), gen_len=8, max_len=20)
    recs = {g: serve.generate(r.port(), {"tokens": torch.from_numpy(prompt), **r.side()},
                              gen_len=8, max_len=20, keep=(0, 6), graph=g)
            for g in (True, False)}
    books = (4,) if key.startswith("audio") else ()
    for rec in recs.values():
        assert rec["tokens"].shape == (2, 8) + books
        np.testing.assert_array_equal(rec["tokens"].numpy(), np.asarray(jtoks))
    if books:
        toks = recs[True]["tokens"]
        assert torch.equal(toks, toks[..., :1].expand_as(toks))
        assert int(toks.max()) < r.tcfg.codebook_vocab
    assert recs[True]["captures"] == 2 and recs[False]["captures"] == 0
    assert all(torch.equal(recs[True]["logits"][i], recs[False]["logits"][i]) for i in (0, 6))


def test_generate_at_a_prompt_as_long_as_the_memory():
    """prompt_len == cross_len = 16: the reference's ``pad_to_cap`` pads
    the cross K/V there too (ROADMAP queue 3), adding zero keys to every
    cross softmax. The port's ``pad_cache`` leaves them, and its greedy
    tokens and kept logits equal the reference's decode over a cache
    padded by key with the cross K/V unpadded."""
    r = ref("audio-fp32")
    plen = r.tcfg.cross_len
    prompt = r.tokens[:, :plen]
    rec = serve.generate(r.port(), {"tokens": torch.from_numpy(prompt), **r.side()},
                         gen_len=6, max_len=plen + 6, keep=(0, 4))
    toks = rec["tokens"].numpy()
    want = _jax_teacher_forced(r, prompt, toks[:, :5], plen + 6)
    for i in range(5):
        got = tp.greedy_next(r.jcfg, jnp.asarray(want[i]))
        np.testing.assert_array_equal(np.asarray(got), toks[:, i + 1:i + 2])
    # measured: 3.7e-7 and 4.0e-7
    assert rel_l2(rec["logits"][0], want[0]) <= 1e-6
    assert rel_l2(rec["logits"][4], want[4]) <= 1e-6


def test_pad_cache_leaves_the_cross_subtree():
    """Self K/V of plen slots padded to max_len on axis -3; a cross
    subtree whose K/V also have plen slots (plen == cross_len) copied as it
    is, by key; ``restore_state`` leaves it alone."""
    plen, max_len = 4, 9
    k, xk = torch.randn(2, 3, plen, 2, 8), torch.randn(2, 3, plen, 2, 8)
    cache = {"groups": {"b0": {"self": {"k": k, "v": k + 1},
                               "cross": {"k": xk, "v": xk + 1}}}}
    out = serve.pad_cache(cache, plen, max_len)
    got = out["groups"]["b0"]
    assert got["self"]["k"].shape == (2, 3, max_len, 2, 8)
    assert torch.equal(got["self"]["k"][:, :, :plen], k) and not got["self"]["k"][:, :, plen:].any()
    for name in ("k", "v"):
        assert torch.equal(got["cross"][name], cache["groups"]["b0"]["cross"][name])
        assert got["cross"][name].data_ptr() != cache["groups"]["b0"]["cross"][name].data_ptr()
    got["cross"]["k"].fill_(7.0)
    serve.restore_state(out, cache)
    assert bool((got["cross"]["k"] == 7.0).all())


@pytest.mark.parametrize("key", ["vlm", "vlm-fp32"])
def test_vision_embeddings_present_and_absent(key):
    """S > nv: the embeddings replace positions 0 … nv - 1, and the logits
    follow them; S <= nv: ``make_batch`` attaches none (the reference's
    rule) and the forward is the text model's; more embeddings than
    positions raise."""
    # measured: S <= nv fp32 3.9e-7, bf16 6.2e-3; with and without the embeddings 1.4 apart
    r = ref(key)
    model = r.port()
    with_ve = _fwd(model, r)
    without = model.forward(torch.from_numpy(r.tokens))
    assert rel_l2(with_ve, without) > 1e-2  # the embeddings reach the logits
    nv = r.tcfg.num_vision_tokens
    short = r.tokens[:, :nv]
    want = r.jm.forward(r.params, {"tokens": jnp.asarray(short)})
    with torch.no_grad():
        got = model.forward(torch.from_numpy(short))
    assert rel_l2(got, want) <= TOL[key]
    for cfg, mb, kw in ((r.tcfg, make_batch, {}), (r.jcfg, jmake_batch, {})):
        assert "vision_embeds" not in mb(cfg, batch=2, seq=nv, **kw)
        assert "vision_embeds" in mb(cfg, batch=2, seq=nv + 1, **kw)
    with pytest.raises(ValueError, match="vision embeddings"):
        model.forward(torch.from_numpy(r.tokens[:, : nv - 1]), **r.side())


@pytest.mark.parametrize("arch", [AUDIO, VLM, "qwen2-tiny"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_make_batch_keys_shapes_and_ranges(arch, smoke):
    """The keys, shapes and dtypes the reference's ``make_batch`` gives,
    tokens in range, side inputs 0.02 · N(0, 1) in bf16."""
    t = (treg.smoke_config if smoke else treg.get_config)(arch)
    j = (jreg.smoke_config if smoke else jreg.get_config)(arch)
    seq = 300 if not smoke else 32  # longer than internvl2's 256 vision tokens
    gen = torch.Generator().manual_seed(0)
    got = make_batch(t, batch=2, seq=seq, generator=gen)
    want = jmake_batch(j, batch=2, seq=seq, kind="serve")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
    vocab = t.codebook_vocab if t.frontend == "audio" else t.vocab_size
    assert 0 <= int(got["tokens"].min()) and int(got["tokens"].max()) < vocab
    for k in ("memory", "vision_embeds"):
        if k in got:
            std = float(got[k].float().std())
            assert 0.018 < std < 0.022 and got[k].dtype == torch.bfloat16
    train = make_batch(t, batch=2, seq=seq, generator=gen, kind="train")
    assert train["labels"].shape == train["tokens"].shape
    assert train["loss_mask"].shape == (2, seq)


def test_act_stat_names_and_quantize():
    """Calibration records every projection's input under the reference's
    names, the cross block's under ``cross`` (``wk``/``wv`` on the
    memory's rows); quantize gives the reference's int8 codes and act
    scales, under the same ``_aq`` names."""
    r = ref("audio")
    model = r.port()
    _, stats = _fwd(model, r, collect_act_stats=True)
    names = [s.name for s in stats]
    assert names == [s.name for s in r.stats]
    assert {f"g0.b0.cross.{n}" for n in ("wq", "wk", "wv", "wo")} <= set(names)
    rows = {s.name: s for s in stats}
    assert rows["g0.b0.cross.wk"].macs * r.tokens.shape[1] == (
        rows["g0.b0.cross.wq"].macs * r.tcfg.cross_len)
    model.quantize(stats)

    def aq_paths(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from aq_paths(v, prefix + (k,))
            elif k.endswith("_aq"):
                yield prefix + (k,)

    assert set(aq_paths(model.state())) == set(aq_paths(r.qparams))
    assert ("layers", "b0", "cross", "wk_aq") in set(aq_paths(model.state()))
    for path, _ in dbb_leaves(model.defs()):
        jq, tq = tree_get(r.qparams, path), tree_get(model.state(), path)
        assert isinstance(tq, QuantDBBWeight)
        np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
        aq = path[:-1] + (path[-1] + "_aq",)
        # measured: 0
        np.testing.assert_allclose(tree_get(model.state(), aq).numpy(),
                                   np.asarray(tree_get(r.qparams, aq)), rtol=1e-5)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_quantized_forward(key):
    """The INT8 model, calibrated on the batch with its side inputs,
    against the reference's unscanned quantized forward."""
    # measured: fp32 2.1e-7 (audio), 2.4e-7 (vlm); bf16 1.3e-5, 3.5e-8
    r = ref(key)
    model = r.port()
    _, stats = _fwd(model, r, collect_act_stats=True)
    model.quantize(stats)
    want = _unscanned(r).forward(r.qparams, r.jbatch())
    assert rel_l2(_fwd(model, r), want) <= 1e-3


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_plan_and_serve_lm_plan_raise(arch):
    """Neither model can be frozen into a single-input plan: ``LM.plan``
    raises as the reference's, and ``serve_lm_plan`` before it builds."""
    r = ref("audio" if arch == AUDIO else "vlm")
    with pytest.raises(NotImplementedError, match="side inputs"):
        r.jm.plan(r.params, batch=2, seq=32, tune="off")
    model = r.port()
    with pytest.raises(NotImplementedError, match="side inputs"):
        model.plan(batch=2, seq=32)
    with pytest.raises(NotImplementedError, match="side inputs"):
        serve.serve_lm_plan(arch, batch=2, prompt_len=32, steps=1, device="cpu", smoke=True,
                            log=lambda *_: None)


@pytest.mark.parametrize("dense", [False, True], ids=["compressed", "dense"])
@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_serve_lm_on_the_cpu(arch, dense):
    """``serve_lm`` at the smoke config: the prompt batch carries its side
    inputs (internvl2's prompt longer than its 8 vision tokens), audio
    tokens come out (B, gen, 4)."""
    logs = []
    rec = serve.serve_lm(arch, batch=2, prompt_len=12, gen=4, device="cpu", smoke=True,
                         dense=dense, log=logs.append)
    cfg = rec["model"].cfg
    books = (cfg.num_codebooks,) if arch == AUDIO else ()
    assert rec["tokens"].shape == (2, 4) + books and rec["captures"] == 2
    side = "memory" if arch == AUDIO else "vision_embeds"
    assert side in rec["inputs"] and any(side in line for line in logs)
    assert torch.equal(rec["inputs"]["tokens"], rec["prompt"])


@pytest.mark.parametrize("arch,flags,expect", [
    (AUDIO, [], "generated (4, 3, 4) tokens"),
    (VLM, [], "generated (4, 3) tokens"),
    (VLM, ["--lm-plan"], "NotImplementedError"),
])
def test_cli_runs_on_the_cpu(arch, flags, expect):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu`` generates (audio tokens one per codebook); ``--lm-plan`` refuses,
    naming the side inputs."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--gen", "3", *flags]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    if flags:
        assert out.returncode != 0 and expect in out.stderr and "side inputs" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert expect in out.stdout


# -------------------------------------------------------------- fixtures


@pytest.fixture(scope="module", params=[AUDIO, VLM])
def golden(request):
    with np.load(tp.FIXTURE_SIDE[request.param]) as z:
        return request.param, unflatten(z)


def test_fixture_matches_the_reference_today(golden):
    arch, g = golden
    live, flat_file = flatten(tp.jax_side_golden(arch)), flatten(g)
    assert set(live) == set(flat_file)
    for k, v in live.items():
        np.testing.assert_array_equal(flat_file[k], v, err_msg=k)
    assert tp.FIXTURE_SIDE[arch].stat().st_size < 1 << 20
    if arch == AUDIO:
        for name in ("embed", "lm_head"):
            assert set(g["params"][name]) == {"seed", "shape", "std", "fp32"}


def test_port_on_the_fixture(golden):
    """What chip_smoke.py phase 11c holds on the card, here on the plain
    versions: the next token equal, prefill and decode logits within 1e-5,
    the quantized forward within 1e-5 as well."""
    arch, g = golden
    cfg = dataclasses.replace(treg.smoke_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = LM(cfg).load_params(params_from_numpy(g["params"], "cpu"))
    side = {k: torch.from_numpy(g[k]) for k in ("memory", "vision_embeds") if k in g}
    tokens = torch.from_numpy(g["tokens"])
    rec = serve.generate(model, {"tokens": tokens, **side}, gen_len=2,
                         max_len=tokens.shape[1] + 1, keep=(0,))
    np.testing.assert_array_equal(rec["tokens"][:, :1].numpy(), g["next"])
    with torch.no_grad():
        pre = model.forward(tokens, **side)[:, -1:]
    # measured: 3.7e-7 / 4.4e-7 (prefill), 4.0e-7 / 4.1e-7 (decode), 1.8e-7 / 1.3e-7 (quantized)
    assert rel_l2(pre, g["prefill"]) <= 1e-5
    assert rel_l2(rec["logits"][0], g["decode"]) <= 1e-5
    model.quantize([ActStats(name=str(n), absmax=float(a))
                    for n, a in zip(g["stats"]["names"], g["stats"]["absmax"])])
    with torch.no_grad():
        assert rel_l2(model.forward(tokens, **side)[:, -1:], g["quant"]) <= 1e-5
