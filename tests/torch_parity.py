"""Helpers for the tests that hold ``repro_torch`` against ``repro``.

Only tests import both packages: this module turns the JAX package's
parameters into numpy trees (the form ``repro_torch.interop`` reads) and
builds the golden fixtures from the JAX reference in ref mode:
``tests/data/torch_parity_cnn.npz`` (one pattern shared across each layer's
outputs, the tc kernels) and ``tests/data/torch_parity_cnn_bw.npz``
(per-column patterns, the bw kernels), and the LM's
``tests/data/torch_parity_lm.npz`` (``qwen2-tiny``, fp32, compressed: its
parameters, the calibration stats its INT8 quantization is made from, a
token batch, the prefill's last-position logits, one decode step's logits
and the quantized forward's last-position logits), and the MoE's
``tests/data/torch_parity_moe.npz`` (``smoke_config("moonshot-v1-16b-a3b")``
computed in fp32 on weights rounded to bf16 values, which the file keeps as
bf16 bits, compressed: a token batch, the prefill's last-position logits,
the next token and one decode step's logits), and the same for the
recurrent decoders' smoke configs (``tests/data/torch_parity_rglru.npz``,
``recurrentgemma-2b``; ``tests/data/torch_parity_rwkv.npz``, ``rwkv6-3b``)
and for MLA's (``tests/data/torch_parity_mla.npz``, ``deepseek-v3-671b``,
with the calibration stats and the quantized forward as the LM's, and its
routed expert stacks kept as numpy seeds, ``interop.seeded_bf16``), and
for the frontends' (``tests/data/torch_parity_audio.npz``,
``musicgen-medium``: audio codebooks and cross-attention to a memory, its
codebook tables and head kept as fp32 seeds, ``interop.seeded_fp32``;
``tests/data/torch_parity_vlm.npz``, ``internvl2-2b``: vision embeddings),
each with its side inputs, calibration stats and quantized forward; and
``tests/data/torch_parity_ckpt/step_00000001``, the reference's checkpoint
of ``torch_parity_cnn.npz``'s quantized params (:func:`write_ckpt_fixture`).
Regenerate all ten with

    PYTHONPATH=src python tests/torch_parity.py
"""
from __future__ import annotations

import dataclasses
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro.configs.cnn import smoke_cnn_config  # noqa: E402
from repro.core.quant import QuantDBBWeight  # noqa: E402
from repro.core.vdbb import DBBWeight  # noqa: E402
from repro.models.cnn import SparseCNN  # noqa: E402
from repro_torch.interop import bf16_bits, flatten, seeded_bf16, seeded_fp32  # noqa: E402

FIXTURE = ROOT / "tests" / "data" / "torch_parity_cnn.npz"
FIXTURE_BW = ROOT / "tests" / "data" / "torch_parity_cnn_bw.npz"
FIXTURE_LM = ROOT / "tests" / "data" / "torch_parity_lm.npz"
FIXTURE_MOE = ROOT / "tests" / "data" / "torch_parity_moe.npz"
FIXTURE_MLA = ROOT / "tests" / "data" / "torch_parity_mla.npz"
FIXTURE_CKPT = ROOT / "tests" / "data" / "torch_parity_ckpt"
LM_BATCH, LM_SEQ = 2, 32
CHAIN_BATCH = 8
CHAIN_SEED = 0
# the fixture holds batch 4 (under 200 KB); its head runs at M = 4, below
# the TPU reference's 8-row tiny-M fallback, which the port does not have
FIXTURE_BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread: when parallel test workers
    share a machine's cores, torch's default of a thread per core in each of
    them oversubscribes it (six copies of a 60-step CPU training test at 8
    threads each took 475 s, at one thread 1.4 s, on 8 cores). Import it
    into a test module to use it; the count is restored after the module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _array(x):
    """A JAX array as numpy; a bf16 one as ``interop.bf16_bits`` carries it."""
    a = np.array(x)
    return bf16_bits(a) if a.dtype == jnp.bfloat16 else a


def to_numpy(tree):
    """A JAX parameter tree as numpy: compressed weights (stacked or not)
    become dicts of ``values, indices[, scales], bz, nnz, group, shape``,
    bf16 arrays ``{"bf16": uint16 bits}``."""
    if isinstance(tree, (DBBWeight, QuantDBBWeight)):
        out = dict(values=_array(tree.values), indices=np.array(tree.indices),
                   bz=tree.fmt.bz, nnz=tree.fmt.nnz, group=tree.fmt.group,
                   shape=np.array(tree.shape))
        if isinstance(tree, QuantDBBWeight):
            out["scales"] = np.array(tree.scales)
        return out
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return _array(tree)


def from_numpy(tree):
    """The inverse of :func:`to_numpy`: a numpy tree (as ``interop.unflatten``
    gives it) as the JAX package's parameter tree."""
    from repro.core.vdbb import DBBFormat

    if isinstance(tree, dict) and "values" in tree:
        group = str(np.asarray(tree["group"]))
        fmt = DBBFormat(int(np.asarray(tree["bz"])), int(np.asarray(tree["nnz"])),
                        None if group == "none" else group if group == "matrix" else int(group))
        shape = tuple(int(s) for s in np.asarray(tree["shape"]).reshape(-1))
        values, indices = from_numpy(tree["values"]), jnp.asarray(tree["indices"])
        if "scales" in tree:
            return QuantDBBWeight(values, indices, jnp.asarray(tree["scales"]), fmt, shape)
        return DBBWeight(values, indices, fmt, shape)
    if isinstance(tree, dict) and set(tree) == {"bf16"}:
        return jnp.asarray(np.asarray(tree["bf16"]).view(jnp.bfloat16))
    if isinstance(tree, dict):
        return {k: from_numpy(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def chain_config(pattern="matrix"):
    """The chain test's model: sparse-cnn-tiny's smoke config with two convs
    per stage (an int8 -> int8 conv, a stride-2 conv, a head at M = batch);
    ``pattern=None`` gives every output column its own pattern."""
    return dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                               convs_per_stage=2)


def random_biases(params: dict, rng: np.random.Generator) -> dict:
    return {k: dict(p, b=jnp.array(rng.normal(0.0, 0.1, p["b"].shape), jnp.float32))
            for k, p in params.items()}


def jax_chain(seed: int = CHAIN_SEED, batch: int = CHAIN_BATCH, pattern="matrix") -> dict:
    """The JAX reference's int8-resident chain in ref mode: input, quantized
    params (numpy), every conv's output, the pooled vector and the logits."""
    cfg = chain_config(pattern)
    model = SparseCNN(cfg)
    rng = np.random.default_rng(seed)
    params = random_biases(model.init(jax.random.PRNGKey(seed)), rng)
    params = model.compress(params)
    x = rng.normal(size=(batch, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)
    _, stats = model.apply(params, jnp.array(x), collect_act_stats=True)
    qparams = model.quantize(params, stats)
    inter = []
    logits = model.apply(qparams, jnp.array(x), intermediates=inter)
    return dict(input=x, params=to_numpy(qparams),
                intermediates={str(i): np.array(t) for i, t in enumerate(inter)},
                pooled=np.array(inter[-1].mean(axis=(1, 2))), logits=np.array(logits))


# the reference's sequence caches by key, and the axis each grows along
SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


def jax_pad_cache(cache, plen: int, max_len: int):
    """The reference's prefill cache with its sequence caches (by key: K/V
    ``k``, ``v``; MLA's ``c_kv``, ``k_rope``) padded to ``max_len`` slots on
    their sequence axis, the layout ``pad_to_cap`` gives K/V; recurrent
    state leaves and a cross block's memory K/V (under ``cross``, read
    whole by decode) as they are. ``pad_to_cap`` itself pads by shape: it
    also pads a state leaf whose axis equals the prompt length, a
    ``c_kv``'s batch axis when the batch does, and the cross K/V when the
    prompt is ``cross_len`` long (ROADMAP queue 3)."""
    def pad(path, a):
        keys = [k.key for k in path]
        axis = SEQ_AXIS.get(keys[-1])
        if axis is None or "cross" in keys:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, max_len - plen)
        return jnp.pad(a, widths)

    return jax.tree_util.tree_map_with_path(pad, cache)


def jax_cache_after(model, params, tokens, max_len: int, side=None):
    """The reference's decode cache after the prompt ``tokens`` (B, S) and
    its side inputs ``side`` (``memory``, ``vision_embeds``), at
    capacity ``max_len``: the prefill's cache through :func:`jax_pad_cache`,
    or, for a model with RG-LRU blocks, the cache its ``decode_step`` builds
    from ``init_cache`` one prompt token at a time (the sequential form its
    own tests hold the scan to). The reference's RG-LRU prefill keeps the
    conv's outputs as the decode window, where its decode reads the conv's
    inputs (ROADMAP queue 3), so its prefill cache is not the state decode
    needs. The decode step is jitted once (eagerly, its scanned layer body
    would be traced anew at every token)."""
    tokens = jnp.asarray(tokens)
    if "rec" not in model.cfg.pattern:
        batch = {"tokens": tokens, **{k: jnp.asarray(v) for k, v in (side or {}).items()}}
        _, cache = model.forward(params, batch, return_cache=True)
        return jax_pad_cache(cache, tokens.shape[1], max_len)
    step = jax.jit(model.decode_step)
    cache = model.init_cache(tokens.shape[0], max_len)
    for t in range(tokens.shape[1]):
        _, cache = step(params, cache, {"tokens": tokens[:, t:t + 1]}, jnp.int32(t))
    return cache


def jax_lm_golden(seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """The JAX reference's ``qwen2-tiny`` in ref mode: compressed params, a
    seeded token batch, the prefill's last-position logits, the next token
    and its decode step's logits (cache padded to seq + 1), the calibration
    stats (name, absmax) of a forward over the batch, and the forward of
    the model quantized with them (last position). The quantized params
    follow from the compressed ones and the stats exactly (``quantize``),
    which keeps the file under 1 MB."""
    from repro.configs.registry import get_config
    from repro.models.model import LM

    model = LM(get_config("qwen2-tiny"))
    params = model.compress(model.init(jax.random.PRNGKey(seed)))
    tokens = np.random.default_rng(seed).integers(0, model.cfg.vocab_size, (batch, seq))
    tokens = jnp.asarray(tokens.astype(np.int32))
    logits, cache, stats = model.forward(params, {"tokens": tokens}, return_cache=True,
                                         collect_act_stats=True)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    step, _ = model.decode_step(params, jax_pad_cache(cache, seq, seq + 1), {"tokens": nxt},
                                jnp.int32(seq))
    qlogits = model.forward(model.quantize(params, stats), {"tokens": tokens})
    return dict(params=to_numpy(params), tokens=np.array(tokens),
                stats={"names": np.array([st.name for st in stats]),
                       "absmax": np.array([st.absmax for st in stats], np.float64)},
                prefill=np.array(logits[:, -1:]), next=np.array(nxt), decode=np.array(step),
                quant=np.array(qlogits[:, -1:]))


MOE_ARCH = "moonshot-v1-16b-a3b"
RECURRENT_ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
FIXTURE_RECURRENT = {"recurrentgemma-2b": ROOT / "tests" / "data" / "torch_parity_rglru.npz",
                     "rwkv6-3b": ROOT / "tests" / "data" / "torch_parity_rwkv.npz"}


def fp32_smoke_model(arch: str):
    """The reference's LM at ``smoke_config(arch)`` computed in fp32."""
    from repro.configs import registry
    from repro.models.model import LM

    return LM(dataclasses.replace(registry.smoke_config(arch), param_dtype=jnp.float32,
                                  compute_dtype=jnp.float32))


def jax_smoke_golden(arch: str, seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """The JAX reference's LM in ref mode at ``smoke_config(arch)`` in
    fp32, so a card can hold the port to it within 1e-5, its weights
    rounded to bf16 values (so the file can carry them as bf16 bits, half
    the bytes) and compressed: a seeded token batch, the prefill's
    last-position logits, the next token and its decode step's logits
    (the cache of :func:`jax_cache_after` at seq + 1 slots)."""
    model = fp32_smoke_model(arch)
    dense = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype),
                                   model.init(jax.random.PRNGKey(seed)))
    params = model.compress(dense)
    tokens = np.random.default_rng(seed).integers(0, model.cfg.vocab_size, (batch, seq))
    tokens = jnp.asarray(tokens.astype(np.int32))
    logits = model.forward(params, {"tokens": tokens})
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    step, _ = model.decode_step(params, jax_cache_after(model, params, tokens, seq + 1),
                                {"tokens": nxt}, jnp.int32(seq))
    bits = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, params)
    return dict(params=to_numpy(bits), tokens=np.array(tokens), prefill=np.array(logits[:, -1:]),
                next=np.array(nxt), decode=np.array(step))


def jax_moe_golden(seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """:func:`jax_smoke_golden` of the MoE (8 experts, top-2, 2 shared)."""
    return jax_smoke_golden(MOE_ARCH, seed, batch, seq)


MLA_ARCH = "deepseek-v3-671b"


def seeded_experts(model, seed: int) -> dict:
    """The routed expert stacks (``we_*``) of ``model``'s tree as
    :func:`interop.seeded_bf16` recipes: normal noise at the fan-in scale,
    one seed a leaf."""
    from repro.models.common import Param

    flat, _ = jax.tree_util.tree_flatten_with_path(model.defs(),
                                                   is_leaf=lambda x: isinstance(x, Param))
    out = {}
    for i, (path, p) in enumerate(flat):
        keys = tuple(k.key for k in path)
        if keys[-1].startswith("we_"):
            out[keys] = dict(seed=np.int64(seed * 1000 + i), shape=np.array(p.shape),
                             std=np.float32(1.0 / np.sqrt(p.shape[-2])))
    return out


def _tree_set(tree, path, val):
    return {**tree, path[0]: val if len(path) == 1 else _tree_set(tree[path[0]], path[1:], val)}


def jax_mla_golden(seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """:func:`jax_smoke_golden` of ``deepseek-v3-671b`` (MLA, 8 routed
    experts, top-2, one shared), plus the calibration stats of a forward
    over the batch and the last-position logits of the model quantized with
    them, as :func:`jax_lm_golden` keeps. The routed expert stacks, 80 % of
    the weights, are drawn from the numpy seeds of :func:`seeded_experts`
    and the file keeps the seeds, which holds it under 1 MB."""
    model = fp32_smoke_model(MLA_ARCH)
    dense = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype),
                                   model.init(jax.random.PRNGKey(seed)))
    experts = seeded_experts(model, seed)
    for path, spec in experts.items():
        bits = seeded_bf16(**spec)["bf16"]
        dense = _tree_set(dense, path, jnp.asarray(bits.view(jnp.bfloat16)).astype(jnp.float32))
    params = model.compress(dense)
    tokens = np.random.default_rng(seed).integers(0, model.cfg.vocab_size, (batch, seq))
    tokens = jnp.asarray(tokens.astype(np.int32))
    logits = model.forward(params, {"tokens": tokens})
    _, stats = model.forward(params, {"tokens": tokens}, collect_act_stats=True)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    step, _ = model.decode_step(params, jax_cache_after(model, params, tokens, seq + 1),
                                {"tokens": nxt}, jnp.int32(seq))
    qlogits = model.forward(model.quantize(params, stats), {"tokens": tokens})
    bits = to_numpy(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, params))
    for path, spec in experts.items():
        bits = _tree_set(bits, path, spec)
    return dict(params=bits, tokens=np.array(tokens), prefill=np.array(logits[:, -1:]),
                next=np.array(nxt), decode=np.array(step),
                stats={"names": np.array([st.name for st in stats]),
                       "absmax": np.array([st.absmax for st in stats], np.float64)},
                quant=np.array(qlogits[:, -1:]))


AUDIO_ARCH, VLM_ARCH = "musicgen-medium", "internvl2-2b"
FIXTURE_SIDE = {AUDIO_ARCH: ROOT / "tests" / "data" / "torch_parity_audio.npz",
                VLM_ARCH: ROOT / "tests" / "data" / "torch_parity_vlm.npz"}


def side_batch(cfg, seed: int, batch: int, seq: int) -> dict:
    """A numpy prompt batch of a frontend or cross-attention config, laid
    out as ``make_batch``'s: tokens (B, S), or (B, S, num_codebooks) from
    ``codebook_vocab`` for audio; ``vision_embeds`` (B, nv, d) when S > nv
    and ``memory`` (B, cross_len, d), 0.02 · N(0, 1) rounded to bf16 values
    and kept as fp32 arrays. Drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    audio = cfg.frontend == "audio"
    shape = (batch, seq, cfg.num_codebooks) if audio else (batch, seq)
    out = {"tokens": rng.integers(0, cfg.codebook_vocab if audio else cfg.vocab_size,
                                  shape).astype(np.int32)}

    def embeds(rows):
        x = np.float32(0.02) * rng.standard_normal((batch, rows, cfg.d_model), dtype=np.float32)
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))

    if cfg.frontend == "vision" and seq > cfg.num_vision_tokens:
        out["vision_embeds"] = embeds(cfg.num_vision_tokens)
    if cfg.cross_attn:
        out["memory"] = embeds(cfg.cross_len)
    return out


def seeded_tables(model, seed: int) -> dict:
    """An audio model's codebook tables (``embed``, (ncb, codebook_vocab,
    d)) and head (``lm_head``, (d, ncb · codebook_vocab)) as
    :func:`interop.seeded_fp32` recipes at the fan-in scale; none for
    another model."""
    if model.cfg.frontend != "audio":
        return {}
    defs = model.defs()
    return {(name,): dict(seed=np.int64(seed * 1000 + i), shape=np.array(defs[name].shape),
                          std=np.float32(1.0 / np.sqrt(defs[name].shape[-2])),
                          fp32=np.bool_(True))
            for i, name in enumerate(("embed", "lm_head"))}


def greedy_next(cfg, logits):
    """The reference ``generate``'s next token from logits (B, 1, V): the
    argmax, for audio taken within a codebook's vocabulary and fed to every
    codebook (B, 1, num_codebooks)."""
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    if cfg.frontend == "audio":
        tok = jnp.broadcast_to(tok[..., None] % cfg.codebook_vocab,
                               tok.shape + (cfg.num_codebooks,))
    return tok


def jax_side_golden(arch: str, seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """:func:`jax_smoke_golden` of a frontend or cross-attention model at
    its smoke config in fp32, fed :func:`side_batch`'s side inputs (kept in
    the file beside the tokens), plus the calibration stats of a forward
    over the batch and the last-position logits of the model quantized with
    them, as :func:`jax_mla_golden` keeps. The next token is ``generate``'s
    (:func:`greedy_next`); the decode step reads the cache of
    :func:`jax_cache_after`, the cross K/V unpadded. An audio model's
    codebook tables and head (8 MB in fp32 at the smoke config) are drawn
    from :func:`seeded_tables`' seeds and the file keeps the seeds."""
    model = fp32_smoke_model(arch)
    dense = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype),
                                   model.init(jax.random.PRNGKey(seed)))
    tables = seeded_tables(model, seed)
    for path, spec in tables.items():
        dense = _tree_set(dense, path, jnp.asarray(seeded_fp32(**spec)))
    params = model.compress(dense)
    inputs = side_batch(model.cfg, seed, batch, seq)
    side = {k: v for k, v in inputs.items() if k != "tokens"}
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    logits = model.forward(params, jb)
    _, stats = model.forward(params, jb, collect_act_stats=True)
    nxt = greedy_next(model.cfg, logits[:, -1:])
    step, _ = model.decode_step(params, jax_cache_after(model, params, inputs["tokens"], seq + 1,
                                                        side),
                                {"tokens": nxt}, jnp.int32(seq))
    qlogits = model.forward(model.quantize(params, stats), jb)
    bits = to_numpy(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, params))
    for path, spec in tables.items():
        bits = _tree_set(bits, path, spec)
    return dict(params=bits, **inputs, prefill=np.array(logits[:, -1:]), next=np.array(nxt),
                decode=np.array(step),
                stats={"names": np.array([st.name for st in stats]),
                       "absmax": np.array([st.absmax for st in stats], np.float64)},
                quant=np.array(qlogits[:, -1:]))


def jax_audio_golden(seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """:func:`jax_side_golden` of ``musicgen-medium`` (4 codebooks of 2048,
    cross-attention to a 16-slot memory)."""
    return jax_side_golden(AUDIO_ARCH, seed, batch, seq)


def jax_vlm_golden(seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """:func:`jax_side_golden` of ``internvl2-2b`` (8 vision embeddings over
    the first positions of a 32-token prompt)."""
    return jax_side_golden(VLM_ARCH, seed, batch, seq)


def write_ckpt_fixture(path: Path = FIXTURE_CKPT) -> Path:
    """The reference's ``checkpoint.store.save`` of the quantized params
    ``torch_parity_cnn.npz`` carries (the chain test's model at
    ``FIXTURE_BATCH``), as step 1 under ``path``: a checkpoint the card,
    which has no JAX, restores into the port."""
    import shutil

    from repro.checkpoint.store import save

    shutil.rmtree(path, ignore_errors=True)
    return save(path, 1, from_numpy(jax_chain(batch=FIXTURE_BATCH)["params"]))


def fixture_bytes(chain: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **flatten(chain))
    return buf.getvalue()


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    for path, pattern in ((FIXTURE, "matrix"), (FIXTURE_BW, None)):
        path.write_bytes(fixture_bytes(jax_chain(batch=FIXTURE_BATCH, pattern=pattern)))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    FIXTURE_LM.write_bytes(fixture_bytes(jax_lm_golden()))
    print(f"wrote {FIXTURE_LM} ({FIXTURE_LM.stat().st_size} bytes)")
    FIXTURE_MOE.write_bytes(fixture_bytes(jax_moe_golden()))
    print(f"wrote {FIXTURE_MOE} ({FIXTURE_MOE.stat().st_size} bytes)")
    for arch, path in FIXTURE_RECURRENT.items():
        path.write_bytes(fixture_bytes(jax_smoke_golden(arch)))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    FIXTURE_MLA.write_bytes(fixture_bytes(jax_mla_golden()))
    print(f"wrote {FIXTURE_MLA} ({FIXTURE_MLA.stat().st_size} bytes)")
    for path, golden in ((FIXTURE_SIDE[AUDIO_ARCH], jax_audio_golden),
                         (FIXTURE_SIDE[VLM_ARCH], jax_vlm_golden)):
        path.write_bytes(fixture_bytes(golden()))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    print(f"wrote {write_ckpt_fixture()}")
