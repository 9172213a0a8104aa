"""The port's checkpoint store (``repro_torch/checkpoint/store.py``) held
against the reference's (``repro/checkpoint/store.py``) on the CPU.

Checkpoints cross both ways leaf for leaf and bit for bit: the quantized
``sparse-cnn-tiny`` smoke state, a tree with bf16 and fp8 leaves, a
``DBBWeight`` and a ``QuantDBBWeight``, and a 12-layer dict whose sorted
key order (``l10`` before ``l2``) the port's flatten must reproduce. The
committed checkpoint the reference wrote (``tests/data/torch_parity_ckpt``)
still verifies and restores. Then the port's twins of
``tests/test_substrate.py::TestCheckpoint``: the atomic round trip, latest
and gc, the structure mismatch, the corruption corpus and the fallback
walk-back (four modes each) and the shape mismatch's path and step.

Two reference tests have no twin yet: ``test_elastic_reshard_on_load``
waits for the port's distribution (ROADMAP item 14, ``restore(device=)``
stands where ``shardings=`` will) and ``test_kill_resume_equivalence`` for
its training loop (item 13).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.checkpoint import store as jstore
from repro.configs.cnn import smoke_cnn_config as jsmoke
from repro.core.quant import QuantDBBWeight as JQuant
from repro.core.vdbb import DBBFormat as JFormat
from repro.core.vdbb import DBBWeight as JDBB
from repro.models.cnn import SparseCNN as JSparseCNN
from repro_torch.checkpoint import store
from repro_torch.configs import cnn as tcfg
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBFormat, DBBWeight
from repro_torch.interop import params_from_numpy, unflatten
from repro_torch.launch.faults import corrupt_checkpoint
from repro_torch.models.cnn import SparseCNN

MODES = ["flip", "truncate", "manifest", "missing"]


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers of its width: equal bits, equal
    arrays, NaN or not."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()]).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _same_leaves(jax_tree, port_tree):
    """The two trees hold the same leaves in the same (JAX flatten) order,
    with the same dtype names and bits."""
    jl = jax.tree_util.tree_leaves(jax_tree)
    pl, paths = store.flatten(port_tree)
    assert len(jl) == len(pl)
    for a, t, path in zip(jl, pl, paths):
        assert str(np.asarray(a).dtype) == str(t.dtype).removeprefix("torch."), path
        assert tuple(np.shape(a)) == tuple(t.shape), path
        np.testing.assert_array_equal(_bits(a), _bits(t), err_msg=path)


@pytest.fixture(scope="module")
def cnn():
    """The quantized ``sparse-cnn-tiny`` smoke state (0.625, 'matrix') in the
    reference, and the same state in the port."""
    cfg = jsmoke("sparse-cnn-tiny", 0.625, "matrix")
    model = JSparseCNN(cfg)
    params = model.compress(model.init(jax.random.PRNGKey(0)))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, cfg.image_size, cfg.image_size, 3))
    _, stats = model.apply(params, x, collect_act_stats=True)
    qparams = model.quantize(params, stats)
    port = SparseCNN(tcfg.smoke_cnn_config("sparse-cnn-tiny", 0.625, "matrix"))
    port.load_state(params_from_numpy(tp.to_numpy(qparams), "cpu"))
    return qparams, port


def test_reference_checkpoint_restores_into_the_port(cnn, tmp_path):
    qparams, port = cnn
    jstore.save(tmp_path, 7, qparams)
    tree, manifest = store.restore(tmp_path, port.state())
    assert manifest["step"] == 7
    _same_leaves(qparams, tree)
    for i, m in enumerate(port.layers()):
        w = tree[f"l{i}"]["w"]
        assert type(w) is type(m.w)
        if isinstance(w, QuantDBBWeight):
            assert w.fmt == m.w.fmt and w.shape == m.w.shape


def test_port_checkpoint_restores_into_the_reference(cnn, tmp_path):
    qparams, port = cnn
    store.save(tmp_path, 3, port.state())
    tree, manifest = jstore.restore(tmp_path, qparams)
    assert manifest["step"] == 3
    _same_leaves(tree, port.state())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(qparams)


def _mixed_trees():
    """One tree in both packages: bf16 and fp8 leaves, a DBBWeight, a
    QuantDBBWeight and a None."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(16, 4)).astype(np.float32)
    bf = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    f8 = rng.normal(size=(6,)).astype(ml_dtypes.float8_e4m3fn)
    vals = rng.normal(size=(2, 3, 4)).astype(np.float32)
    idx = np.broadcast_to(np.array([0, 3, 5], np.int8)[None, :, None], (2, 3, 4)).copy()
    qv = rng.integers(-127, 128, size=(2, 3, 4)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(4,)).astype(np.float32)
    jfmt, fmt = JFormat(8, 3, None), DBBFormat(8, 3, None)
    jtree = {"w": jnp.asarray(f32), "bf16": jnp.asarray(bf), "fp8": jnp.asarray(f8),
             "dbb": JDBB(jnp.asarray(vals), jnp.asarray(idx), jfmt, (16, 4)),
             "q": {"w": JQuant(jnp.asarray(qv), jnp.asarray(idx), jnp.asarray(scales), jfmt,
                               (16, 4)), "none": None}}
    ttree = {"w": torch.from_numpy(f32),
             "bf16": torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16),
             "fp8": torch.from_numpy(f8.view(np.uint8)).view(torch.float8_e4m3fn),
             "dbb": DBBWeight(torch.from_numpy(vals), torch.from_numpy(idx), fmt, (16, 4)),
             "q": {"w": QuantDBBWeight(torch.from_numpy(qv), torch.from_numpy(idx),
                                       torch.from_numpy(scales), fmt, (16, 4)), "none": None}}
    return jtree, ttree


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_fp8_and_compressed_leaves_cross_both_ways(tmp_path, writer):
    jtree, ttree = _mixed_trees()
    if writer == "reference":
        jstore.save(tmp_path, 1, jtree)
        tree, _ = store.restore(tmp_path, ttree)
        assert tree["q"]["none"] is None and tree["q"]["w"].fmt == ttree["q"]["w"].fmt
        assert tree["bf16"].dtype == torch.bfloat16 and tree["fp8"].dtype == torch.float8_e4m3fn
        _same_leaves(jtree, tree)
    else:
        store.save(tmp_path, 1, ttree)
        tree, _ = jstore.restore(tmp_path, jtree)
        assert tree["bf16"].dtype == jnp.bfloat16 and isinstance(tree["dbb"], JDBB)
        _same_leaves(tree, ttree)


def test_dict_keys_flatten_sorted_as_strings(tmp_path):
    """Twelve layers: JAX orders ``l10`` and ``l11`` before ``l2``, and so
    does the port, so a leaf lands on its own key across the packages."""
    jtree = {f"l{i}": {"w": jnp.full((2,), float(i)), "b": jnp.full((1,), -float(i))}
             for i in range(12)}
    ttree = {f"l{i}": {"w": torch.zeros(2), "b": torch.zeros(1)} for i in range(12)}
    _, paths = store.flatten(ttree)
    assert paths[:4] == ["['l0']['b']", "['l0']['w']", "['l1']['b']", "['l1']['w']"]
    assert paths[4:6] == ["['l10']['b']", "['l10']['w']"]
    jstore.save(tmp_path, 1, jtree)
    tree, _ = store.restore(tmp_path, ttree)
    for i in range(12):
        assert tree[f"l{i}"]["w"].tolist() == [float(i)] * 2
        assert tree[f"l{i}"]["b"].tolist() == [-float(i)]
    _same_leaves(jtree, tree)


def test_int4_leaf_raises_typed(tmp_path):
    jstore.save(tmp_path, 1, {"w": jnp.arange(4, dtype=jnp.int4)})
    with pytest.raises(store.UnsupportedDtypeError, match="int4"):
        store.restore(tmp_path, {"w": torch.zeros(4, dtype=torch.int8)})


def test_committed_reference_checkpoint_verifies_and_restores():
    """The reference wrote it (``torch_parity.write_ckpt_fixture``): it still
    verifies in both packages, and restores into the port leaf for leaf
    equal to the quantized params of ``torch_parity_cnn.npz``."""
    manifest, raw = store.read_verified(tp.FIXTURE_CKPT)
    assert manifest["step"] == 1 and store.list_steps(tp.FIXTURE_CKPT) == [1]
    jstore.read_verified(tp.FIXTURE_CKPT)
    assert sum(f.stat().st_size for f in tp.FIXTURE_CKPT.rglob("*") if f.is_file()) < 1_000_000
    with np.load(tp.FIXTURE) as z:
        params = unflatten(z)["params"]
    want = params_from_numpy(params, "cpu")
    cfg = dataclasses.replace(tcfg.smoke_cnn_config("sparse-cnn-tiny"), convs_per_stage=2)
    template = SparseCNN(cfg).load_state(want).state()
    tree, _ = store.restore(tp.FIXTURE_CKPT, template)
    _same_leaves(tp.from_numpy(params), tree)


# ------------------------------------------------ twins of TestCheckpoint


def test_atomic_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    store.save(tmp_path, 3, tree, extra={"note": "x"})
    out, manifest = store.restore(tmp_path, tree)
    assert manifest["step"] == 3 and manifest["extra"] == {"note": "x"}
    assert torch.equal(out["a"], tree["a"]) and out["b"]["c"].dtype == torch.bfloat16
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("tmp.")]


def test_latest_and_gc(tmp_path):
    tree = {"a": torch.zeros(2)}
    ck = store.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, tree)
    ck.wait()
    assert store.list_steps(tmp_path) == [2, 3]
    assert store.latest_step(tmp_path) == 3


def test_structure_mismatch_rejected(tmp_path):
    store.save(tmp_path, 0, {"a": torch.zeros(2)})
    with pytest.raises(AssertionError):
        store.restore(tmp_path, {"a": torch.zeros(2), "b": torch.zeros(1)})


@pytest.mark.parametrize("mode", MODES)
def test_corruption_corpus_fails_typed(tmp_path, mode):
    """A flipped byte, a torn write, a manifest edited without re-digesting
    and a deleted archive each raise CorruptCheckpointError, never garbage."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8, dtype=torch.bfloat16)}
    store.save(tmp_path, 1, tree)
    corrupt_checkpoint(tmp_path, mode=mode)
    with pytest.raises(store.CorruptCheckpointError):
        store.restore(tmp_path, tree)


@pytest.mark.parametrize("mode", MODES)
def test_fallback_walks_back_to_verifiable_step(tmp_path, mode):
    tree = {"w": torch.arange(12, dtype=torch.float32)}
    store.save(tmp_path, 1, {"w": tree["w"] + 1})
    store.save(tmp_path, 2, tree)
    corrupt_checkpoint(tmp_path, step=2, mode=mode)
    out, manifest = store.restore(tmp_path, tree, fallback=True)
    assert manifest["step"] == 1
    assert torch.equal(out["w"], torch.arange(12, dtype=torch.float32) + 1)
    corrupt_checkpoint(tmp_path, step=1, mode=mode)
    with pytest.raises(store.CorruptCheckpointError, match="no verifiable"):
        store.restore(tmp_path, tree, fallback=True)


def test_shape_mismatch_reports_path_and_step(tmp_path):
    store.save(tmp_path, 5, {"enc": {"w": torch.zeros((2, 3))}})
    with pytest.raises(ValueError, match=r"'w'.*step 5.*\(2, 3\)"):
        store.restore(tmp_path, {"enc": {"w": torch.zeros((3, 3))}})
