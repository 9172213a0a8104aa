"""repro_torch's recurrent decoders held against the JAX reference on the
CPU: ``models/recurrent.py`` (the causal conv, the RG-LRU scan and block,
the chunked WKV and the RWKV6 block), the two LMs built on them
(``recurrentgemma-2b``: RG-LRU and local attention, tied embeddings,
embedding scale, logit soft-cap; ``rwkv6-3b``), calibration, the INT8
forward and plan (the recurrent projections staged with dynamic scales),
``generate`` and the two golden fixtures the card reads.

Inputs come from numpy seeds; parameters from the JAX package
(``torch_parity.to_numpy`` -> ``interop.params_from_numpy``). JAX runs in
ref mode; the port runs its kernels' plain versions. Models: the arches'
smoke configs in bf16 (as registered) and in fp32.

Tolerances, each with the value this file measured beside it:
  - defs, param counts, activation-stat names, the ``_aq`` leaves, greedy
    tokens, the plan against the unplanned forward: equal;
  - fp32 within 1e-5 relative L2 (summation order: the doubling scan
    against ``associative_scan``'s tree, torch's reductions against XLA's);
  - bf16 within 2e-2 relative L2 against the reference compiled with XLA's
    excess precision off (the written cast order), the tolerance
    ``test_torch_lm.py`` holds the bf16 LM to;
  - the quantized forward within 1e-3 (an int8 code may flip at a
    rounding tie).

Decode after a prefill is held against the reference's ``decode_step`` on
the cache ``torch_parity.jax_cache_after`` gives: the prefill's with its
K/V padded by key, or for RG-LRU models the one the reference's decode
builds token by token, since the reference's RG-LRU prefill keeps the
conv's outputs where its decode reads the conv's inputs (ROADMAP queue 3;
``test_rglru_prefill_keeps_the_conv_inputs_decode_reads``).
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
from repro.models import recurrent as jrec
from repro.models.common import Param as JParam
from repro.models.common import init_params as jinit
from repro.models.model import LM as JLM
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.act_sparsity import ActStats
from repro_torch.core.quant import quantize_dbb
from repro_torch.core.vdbb import DBBFormat, dbb_encode
from repro_torch.interop import flatten, params_from_numpy, unflatten
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import recurrent as trec
from repro_torch.models.common import param_leaves
from repro_torch.models.model import LM
from repro_torch.train.step import make_prefill, make_serve_step

ARCHS = tp.RECURRENT_ARCHS


def rel_l2(a, b) -> float:
    def arr(x):
        return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)

    a, b = arr(a), arr(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(x):
    """A JAX array (or numpy) as a torch tensor of the same dtype."""
    a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    out = torch.from_numpy(np.array(a))
    return out.bfloat16() if x.dtype == jnp.bfloat16 else out


def tree_t(tree):
    return params_from_numpy(tp.to_numpy(tree), "cpu")


def written(fn, *args):
    """``fn`` jitted and compiled with XLA's excess precision off: every
    bf16 op rounds where the reference's code casts."""
    f = jax.jit(fn)
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _cfgs(arch, fp32):
    """The reference's and the port's smoke config of ``arch`` (as
    registered: bf16; or in fp32)."""
    jcfg, tcfg = jreg.smoke_config(arch), smoke_config(arch)
    if fp32:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    return jcfg, tcfg


class Ref:
    """One config's reference run: dense and compressed params, tokens, the
    prefill logits (and compiled with the written rounding), the
    calibration stats, the quantized params and the logits of the
    reference's unscanned forward on them (op by op: every cast kept, the
    form the port's loop over groups mirrors)."""

    def __init__(self, arch, fp32, seed=0, batch=2, seq=32):
        self.jcfg, self.tcfg = _cfgs(arch, fp32)
        self.jm = JLM(self.jcfg)
        self.dense = self.jm.init(jax.random.PRNGKey(seed))
        self.params = self.jm.compress(self.dense)
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, self.jcfg.vocab_size, (batch, seq)).astype(np.int32)
        toks = jnp.asarray(self.tokens)
        self.logits, self.stats = self.jm.forward(self.params, {"tokens": toks},
                                                  collect_act_stats=True)
        self.wlogits = written(lambda p, x: self.jm.forward(p, {"tokens": x}), self.params, toks)
        self.qparams = self.jm.quantize(self.params, self.stats)
        unscanned = JLM(dataclasses.replace(self.jcfg, scan_layers=False, remat="none"))
        self.qlogits = unscanned.forward(self.qparams, {"tokens": toks})
        self.tol = 1e-5 if fp32 else 2e-2

    def port(self, tree=None) -> LM:
        return LM(self.tcfg).load_params(
            params_from_numpy(tp.to_numpy(self.params if tree is None else tree), "cpu"))


_REFS = {}
KEYS = [(a, f) for a in ARCHS for f in (True, False)]
IDS = [f"{a}-{'fp32' if f else 'bf16'}" for a, f in KEYS]


def ref(arch, fp32) -> Ref:
    if (arch, fp32) not in _REFS:
        _REFS[arch, fp32] = Ref(arch, fp32)
    return _REFS[arch, fp32]


def _fwd(model, tokens, **kw):
    with torch.no_grad():
        return model.forward(torch.from_numpy(np.asarray(tokens)), **kw)


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("width,dtype", [(4, "float32"), (4, "bfloat16"), (1, "float32"),
                                         (3, "bfloat16")])
def test_causal_conv1d(width, dtype):
    rng = np.random.default_rng(width)
    u = jnp.asarray(rng.normal(size=(2, 9, 16)), dtype)
    k = jnp.asarray(rng.normal(size=(width, 16)) * 0.5, jnp.float32)
    want = written(jrec._causal_conv1d, u, k)
    got = trec.causal_conv1d(t(u), t(k))
    assert got.dtype == t(u).dtype
    # measured: 3.9e-8 (fp32, width 4), 0 (bf16: the same fp32 sums, one rounding)
    assert rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("s", [1, 5, 64, 256])
def test_scan_linear_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.0, 1.0, (2, s, 8)).astype(np.float32)
    b = rng.normal(size=(2, s, 8)).astype(np.float32)
    _, want = jax.lax.associative_scan(lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
                                       (jnp.asarray(a), jnp.asarray(b)), axis=1)
    # measured: 6.1e-8 at s = 64 and 256, 0 at s = 1
    assert rel_l2(trec.scan_linear(torch.from_numpy(a), torch.from_numpy(b)), want) <= 1e-5


def _wkv_inputs(s, seed, decay=None):
    rng = np.random.default_rng(seed)
    b, h, d = 2, 3, 8
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    if decay is None:
        wlog = -np.exp(rng.normal(size=(b, s, h, d))).astype(np.float32)
    else:
        wlog = np.full((b, s, h, d), decay, np.float32)
    u = (0.3 * rng.normal(size=(h, d))).astype(np.float32)
    return r, k, v, wlog, u


@pytest.mark.parametrize("s,chunk,decay", [(32, 8, None), (16, 16, None), (21, 8, None),
                                           (7, 16, None), (64, 16, -50.0), (40, 16, -1e-6)])
def test_wkv_chunked(s, chunk, decay):
    """S % chunk = 0 and not, a sequence shorter than a chunk, and extreme
    decays (near-instant forgetting, none at all): the output and the final
    state against the reference's."""
    r, k, v, wlog, u = _wkv_inputs(s, s + chunk, decay)
    want_y, want_s = jrec.wkv_chunked(*map(jnp.asarray, (r, k, v, wlog, u)), chunk=chunk)
    y, state = trec.wkv_chunked(*map(torch.from_numpy, (r, k, v, wlog, u)), chunk=chunk)
    assert y.shape == (2, s, 3, 8) and state.shape == (2, 3, 8, 8)
    assert bool(torch.isfinite(y).all() and torch.isfinite(state).all())
    # measured: 7.5e-7 at most (s = chunk = 16), 0 for the state at decay -50
    assert rel_l2(y, want_y) <= 1e-5 and rel_l2(state, want_s) <= 1e-5


def _block_params(block, seed, dtype):
    return jax.tree_util.tree_map(lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a,
                                  jinit(block.defs(), jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_rglru_block_forward_and_decode(fp32):
    """The block over 12 steps, then 4 decode steps from its prefill state,
    each against the reference's decode on the state its own decode built
    over the same 12 steps."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", fp32)
    dt = jcfg.compute_dtype
    jb, tb = jrec.RGLRUBlock(jcfg), trec.RGLRUBlock(tcfg)
    p = _block_params(jb, 0, dt)
    x = jnp.asarray(0.5 * np.random.default_rng(1).normal(size=(2, 16, jcfg.d_model)), dt)
    want_y, want_state = written(jb, p, x[:, :12])
    tp_ = tree_t(p)
    with torch.no_grad():
        y, state = tb(tp_, t(x[:, :12]))
    tol = 1e-5 if fp32 else 2e-2
    # measured: 1.1e-7 (fp32), 0 (bf16)
    assert rel_l2(y, want_y) <= tol and rel_l2(state["h"], want_state["h"]) <= tol
    jcache = jb.init_cache(2, 16, dt)
    for i in range(12):
        _, jcache = jb.decode(p, x[:, i:i + 1], jcache, i)
    assert rel_l2(state["conv"], jcache["conv"]) <= tol
    worst = 0.0
    for i in range(12, 16):
        jy, jcache = jb.decode(p, x[:, i:i + 1], jcache, i)
        with torch.no_grad():
            ty, state = tb.decode(tp_, t(x[:, i:i + 1]), state, i)
        worst = max(worst, rel_l2(ty, jy), rel_l2(state["h"], jcache["h"]))
    # measured: 1.1e-7 (fp32), 9.4e-6 (bf16: the prefill's h is rounded to bf16)
    assert worst <= tol


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_rwkv6_block_forward_and_decode(fp32):
    """Time and channel mix over 12 steps (WKV chunks of 16: a zero-padded
    tail), then 4 decode steps from their state, against the reference."""
    jcfg, tcfg = _cfgs("rwkv6-3b", fp32)
    dt = jcfg.compute_dtype
    jb, tb = jrec.RWKV6Block(jcfg), trec.RWKV6Block(tcfg)
    p = _block_params(jb, 0, dt)
    rng = np.random.default_rng(2)
    # nonzero mixes, so that the shifted token reaches every channel
    for key in ("mu", "mu_x"):
        p["tm"][key] = jnp.asarray(rng.uniform(0, 1, p["tm"][key].shape), dt)
    for key in ("mu_k", "mu_r"):
        p["cm"][key] = jnp.asarray(rng.uniform(0, 1, p["cm"][key].shape), dt)
    x = jnp.asarray(0.5 * rng.normal(size=(2, 16, jcfg.d_model)), dt)
    zero = jnp.zeros((2, jcfg.d_model), dt)

    def ref_full(p, x):
        y, cache = jb.time_mix(p["tm"], x, zero)
        y2, cm_shift = jb.channel_mix(p["cm"], x, zero)
        return y, y2, {**cache, "cm_shift": cm_shift}

    want_y, want_y2, want_cache = written(ref_full, p, x[:, :12])
    tp_ = tree_t(p)
    tzero = t(zero)
    with torch.no_grad():
        y, cache = tb.time_mix(tp_["tm"], t(x[:, :12]), tzero)
        y2, cm_shift = tb.channel_mix(tp_["cm"], t(x[:, :12]), tzero)
    cache["cm_shift"] = cm_shift
    tol = 1e-5 if fp32 else 2e-2
    # measured: 2.3e-6 (fp32), 1.5e-4 (bf16)
    assert rel_l2(y, want_y) <= tol and rel_l2(y2, want_y2) <= tol
    for key in ("s", "shift", "cm_shift"):
        assert rel_l2(cache[key], want_cache[key]) <= tol, key
    jcache = want_cache
    worst = 0.0
    for i in range(12, 16):
        xi = x[:, i:i + 1]
        jy, jtm = jb.time_mix_decode(p["tm"], xi, jcache)
        jy2, jcm = jb.channel_mix_decode(p["cm"], xi, jcache["cm_shift"])
        jcache = {**jtm, "cm_shift": jcm}
        with torch.no_grad():
            ty, _ = tb.time_mix_decode(tp_["tm"], t(xi), cache)
            ty2 = tb.channel_mix_decode(tp_["cm"], t(xi), cache)
        worst = max(worst, rel_l2(ty, jy), rel_l2(ty2, jy2), rel_l2(cache["s"], jcache["s"]))
    # measured: 2.8e-7 (fp32), 9.7e-8 (bf16)
    assert worst <= tol


# -------------------------------------------------------------- the LMs


@pytest.mark.parametrize("arch", ARCHS)
def test_defs_paths_shapes_and_param_count(arch):
    for smoke in (True, False):
        j = (jreg.smoke_config if smoke else jreg.get_config)(arch)
        tc = (smoke_config if smoke else get_config)(arch)
        flat, _ = jax.tree_util.tree_flatten_with_path(JLM(j).defs(),
                                                       is_leaf=lambda x: isinstance(x, JParam))
        jl = {tuple(k.key for k in path): p for path, p in flat}
        tl = dict(param_leaves(LM(tc).defs()))
        assert set(tl) == set(jl) and not any(path[0] == "lm_head" for path in tl) == (
            arch == "recurrentgemma-2b")
        for path, p in tl.items():
            q = jl[path]
            assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
            assert (p.dbb is None) == (q.dbb is None), path
        assert tc.param_count() == j.param_count()
    assert get_config(arch).param_count() == {"recurrentgemma-2b": 2_894_435_840,
                                              "rwkv6-3b": 3_073_643_520}[arch]


@pytest.mark.parametrize("arch,fp32", KEYS, ids=IDS)
def test_prefill_logits(arch, fp32):
    # measured: 3.3e-7 / 2.4e-6 (fp32), 1.1e-3 / 1.9e-7 (bf16, recurrentgemma / rwkv6)
    r = ref(arch, fp32)
    logits = _fwd(r.port(), r.tokens)
    assert logits.shape == tuple(r.logits.shape) and logits.dtype == r.tcfg.compute_dtype
    assert rel_l2(logits, r.wlogits) <= r.tol


@pytest.mark.parametrize("arch,fp32", KEYS, ids=IDS)
def test_teacher_forced_decode_logits(arch, fp32):
    """A 24-token prefill, then 8 forced tokens through ``decode_step``,
    each step's logits against the reference's."""
    r = ref(arch, fp32)
    prompt, forced = r.tokens[:, :24], r.tokens[:, 24:]
    cache = tp.jax_cache_after(r.jm, r.params, prompt, 32)
    step, want = jax.jit(r.jm.decode_step), []
    for i in range(forced.shape[1]):
        lg, cache = step(r.params, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])},
                         jnp.int32(24 + i))
        want.append(lg)
    model = r.port()
    prefill, step = make_prefill(model), make_serve_step(model)
    _, tcache = prefill({"tokens": torch.from_numpy(prompt)})
    tcache = serve.pad_cache(tcache, 24, 32)
    worst = 0.0
    for i in range(forced.shape[1]):
        lg, tcache = step(tcache, {"tokens": torch.from_numpy(forced[:, i:i + 1])}, 24 + i)
        worst = max(worst, rel_l2(lg, want[i]))
    # measured: 3.4e-7 / 1.1e-6 (fp32), 1.0e-2 / 1.1e-2 (bf16: the reference's decode
    # scans its layers under XLA's default excess precision)
    assert worst <= r.tol


def test_rglru_prefill_keeps_the_conv_inputs_decode_reads():
    """The port's prefill leaves the RG-LRU decode window the reference's
    own decode builds over the same tokens; the reference's prefill leaves
    the conv's outputs there (``recurrent.py:62``), a reference fault."""
    r = ref("recurrentgemma-2b", True)
    _, tcache = _fwd(r.port(), r.tokens, return_cache=True)
    _, jpre = r.jm.forward(r.params, {"tokens": jnp.asarray(r.tokens)}, return_cache=True)
    jdec = tp.jax_cache_after(r.jm, r.params, r.tokens, 33)
    conv, dec_conv = tcache["groups"]["b0"]["conv"], jdec["groups"]["b0"]["conv"]
    # measured: 1.5e-7 against the decode's window, 1.4 against the prefill's
    assert rel_l2(conv, dec_conv) <= 1e-5
    assert rel_l2(jpre["groups"]["b0"]["conv"], dec_conv) > 0.1


@pytest.mark.parametrize("arch,fp32", KEYS, ids=IDS)
def test_act_stat_names_and_aq_leaves(arch, fp32):
    """Calibration records the recurrent projections under their block's
    scope with no name, as the reference does, so they get no ``_aq``: the
    names, their count and the set of ``_aq`` leaves equal the
    reference's."""
    r = ref(arch, fp32)
    model = r.port()
    _, stats = _fwd(model, r.tokens, collect_act_stats=True)
    assert sorted(s.name for s in stats) == sorted(s.name for s in r.stats)
    # a name repeats (every projection of a recurrent block records under
    # the block's scope): in record order, each record against its twin
    assert [s.name for s in stats] == [s.name for s in r.stats]
    worst = max(abs(s.absmax - j.absmax) / j.absmax for s, j in zip(stats, r.stats))
    # measured: 5.3e-7 / 1.7e-6 (fp32), 0 (bf16)
    assert worst <= 1e-5
    model.quantize(stats)

    def aq_paths(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from aq_paths(v, prefix + (k,))
            elif k.endswith("_aq"):
                yield prefix + (k,)

    taq = set(aq_paths(model.state()))
    assert taq == set(aq_paths(r.qparams))
    assert not any("mixer" in p and "b2" not in p for p in taq)  # no recurrent projection


@pytest.mark.parametrize("arch,fp32", KEYS, ids=IDS)
def test_quantized_forward_and_plan_bit_for_bit(arch, fp32):
    """Quantize with the reference's calibration stats (the recurrent
    projections dynamic) and run the port against the reference's
    unscanned quantized forward; then ``LM.plan``, its stages the reference's, equal
    to the unplanned INT8 forward bit for bit. The reference's stats, not
    the port's, because the smoke recurrentgemma is sensitive to one int8
    code: its fp32 activations differ from the reference's by an ulp (so
    do their absmax, ``test_act_stat_names_and_aq_leaves``), and one
    ``w_down`` scale an ulp off flips a code that moves the logits by
    1.5e-2; the calibration itself is held there. For the same reason the
    reference's scanned compile (3.4e-3 from its own unscanned forward in
    fp32) is not the yardstick."""
    r = ref(arch, fp32)
    model = r.port()
    model.quantize([ActStats(name=s.name, absmax=s.absmax) for s in r.stats])
    got = _fwd(model, r.tokens)
    # measured: 1.7e-7 / 1.9e-7 (fp32), 4.7e-5 / 1.5e-6 (bf16)
    assert rel_l2(got, r.qlogits) <= 1e-3
    plan = model.plan(batch=2, seq=32)
    jplan = r.jm.plan(r.qparams, batch=2, seq=32, tune="off")
    assert [l.name for l in plan.layers] == [l.name for l in jplan.layers]
    with torch.no_grad():
        assert torch.equal(plan(torch.from_numpy(r.tokens)), got)
    assert plan.trace_count == 1


def test_staged_quant_matmul_dynamic_equals_unplanned():
    """The staged INT8 product without a calibrated scale: with
    ``dynamic`` it writes each call's scale product into its flush row and
    gives the unplanned dynamic product's bits, call after call; without,
    it refuses, as the CNN's staged layers do."""
    gen = torch.Generator().manual_seed(0)
    qw = quantize_dbb(dbb_encode(torch.randn(64, 24, generator=gen), DBBFormat(8, 3, "matrix"),
                                 prune=True))
    run, _ = ops.stage_quant_matmul(qw, None, 5, dynamic=True)
    for scale in (1.0, 30.0, 1e-3):
        x = torch.randn(5, 64, generator=gen) * scale
        assert torch.equal(run(x), ops.quant_matmul(x, qw, None))
    with pytest.raises(ValueError, match="calibrated"):
        ops.stage_quant_matmul(qw, None, 5)
    with pytest.raises(ValueError, match="activation scale"):
        run(torch.zeros(5, 64, dtype=torch.int8))


# --------------------------------------------------------------- generate


def _jax_generate(r, prompt, gen_len):
    """The reference's greedy tokens: the forward's next token, then its
    ``decode_step`` on the cache of ``jax_cache_after``."""
    plen = prompt.shape[1]
    logits = r.jm.forward(r.params, {"tokens": jnp.asarray(prompt)})
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    cache = tp.jax_cache_after(r.jm, r.params, prompt, plen + gen_len)
    step, out = jax.jit(r.jm.decode_step), [tok]
    for i in range(gen_len - 1):
        lg, cache = step(r.params, cache, {"tokens": tok}, jnp.int32(plen + i))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,batch,plen", [
    ("recurrentgemma-2b", 2, 2),   # the layer groups
    ("recurrentgemma-2b", 2, 3),   # conv1d_width - 1
    ("recurrentgemma-2b", 3, 3),   # the batch
    ("rwkv6-3b", 2, 2),            # the batch and the layer groups
    ("rwkv6-3b", 2, 4),            # rwkv_heads
    ("rwkv6-3b", 5, 5),            # batch = prompt length
    ("rwkv6-3b", 2, 32),           # the long prompt
])
def test_generate_at_prompt_lengths_that_match_a_state_axis(arch, batch, plen):
    """fp32 greedy generation of 6 tokens where a recurrent state leaf has
    an axis equal to the prompt length, which the reference's
    ``pad_to_cap`` pads; the port pads K/V by key. Tokens equal to the
    reference's forward and decode steps; ``graph=True`` (nothing is
    captured on the CPU) equals ``graph=False``."""
    r = ref(arch, True)
    prompt = np.random.default_rng(plen).integers(0, r.jcfg.vocab_size,
                                                  (batch, plen)).astype(np.int32)
    want = _jax_generate(r, prompt, 6)
    model = r.port()
    rec = serve.generate(model, {"tokens": torch.from_numpy(prompt)}, gen_len=6,
                         max_len=plen + 6, keep=(0, 4))
    eager = serve.generate(model, {"tokens": torch.from_numpy(prompt)}, gen_len=6,
                           max_len=plen + 6, keep=(0, 4), graph=False)
    np.testing.assert_array_equal(rec["tokens"].numpy(), want)
    assert torch.equal(rec["tokens"], eager["tokens"])
    assert all(torch.equal(rec["logits"][i], eager["logits"][i]) for i in (0, 4))
    assert rec["captures"] == 2 and eager["captures"] == 0


def test_pad_cache_pads_kv_by_key_and_copies_the_state():
    """A state leaf whose axis equals the prompt length is not padded: the
    rwkv state (G, B, H, hd, hd) at H = plen, the RG-LRU window (G, B, W -
    1, d) at W - 1 = plen; K/V get plen slots of max_len."""
    plen, max_len = 3, 7
    kv = torch.randn(2, 2, plen, 1, 4)
    cache = {"groups": {"b0": {"h": torch.randn(2, 2, 8), "conv": torch.randn(2, 2, plen, 8)},
                        "b1": {"s": torch.randn(2, 2, plen, 4, 4), "shift": torch.randn(2, 2, 8)},
                        "b2": {"k": kv, "v": kv + 1}}}
    out = serve.pad_cache(cache, plen, max_len)
    for key in ("b0", "b1"):
        for name, v in cache["groups"][key].items():
            got = out["groups"][key][name]
            assert torch.equal(got, v) and got.data_ptr() != v.data_ptr()
    k = out["groups"]["b2"]["k"]
    assert k.shape == (2, 2, max_len, 1, 4) and torch.equal(k[:, :, :plen], kv)
    assert not k[:, :, plen:].any()


# --------------------------------------------------------------- fixtures


@pytest.fixture(scope="module", params=ARCHS)
def golden(request):
    with np.load(tp.FIXTURE_RECURRENT[request.param]) as z:
        return request.param, unflatten(z)


def test_fixture_matches_the_reference_today(golden):
    arch, g = golden
    live, flat_file = flatten(tp.jax_smoke_golden(arch)), flatten(g)
    assert set(live) == set(flat_file)
    for k, v in live.items():
        np.testing.assert_array_equal(flat_file[k], v, err_msg=k)
    assert tp.FIXTURE_RECURRENT[arch].stat().st_size < 1 << 20


def test_port_on_the_fixture(golden):
    """What chip_smoke.py phase 9c holds on the card, here on the plain
    versions: the next token equal, prefill and decode logits within
    1e-5."""
    arch, g = golden
    cfg = dataclasses.replace(smoke_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = LM(cfg).load_params(params_from_numpy(g["params"], "cpu"))
    tokens = torch.from_numpy(g["tokens"])
    rec = serve.generate(model, {"tokens": tokens}, gen_len=2, max_len=tokens.shape[1] + 1,
                         keep=(0,))
    np.testing.assert_array_equal(rec["tokens"][:, :1].numpy(), g["next"])
    # measured: 3.7e-7 / 2.3e-6 (prefill), 3.0e-7 / 1.9e-6 (decode), recurrentgemma / rwkv6
    assert rel_l2(_fwd(model, g["tokens"])[:, -1:], g["prefill"]) <= 1e-5
    assert rel_l2(rec["logits"][0], g["decode"]) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_points_run_on_the_cpu(arch):
    """``serve_lm`` and ``serve_lm_plan`` at the smoke config with
    ``device='cpu'`` (the CLI's ``--smoke --device cpu``)."""
    lines = []
    rec = serve.serve_lm(arch, batch=2, prompt_len=8, gen=3, device="cpu", smoke=True,
                         log=lines.append)
    assert rec["tokens"].shape == (2, 3) and "generated (2, 3) tokens" in lines[-1]
    plan = serve.serve_lm_plan(arch, batch=2, prompt_len=8, steps=1, device="cpu", smoke=True,
                               log=lines.append)
    assert plan["bit_identical"] and plan["captures"] == 1
