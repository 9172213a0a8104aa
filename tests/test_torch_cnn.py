"""repro_torch's SparseCNN held against the JAX reference, and the slice as
a whole: configs, the in-place lifecycle, the fp calibration forward, the
int8-resident chain on the JAX package's own quantized params, the golden
fixture the card reads, the serving entry point and the import guard.

The chain runs ``smoke_cnn_config("sparse-cnn-tiny")`` with two convs per
stage at batch 8 with random nonzero biases: an int8 -> int8 conv, a
stride-2 conv and a head at M = 8. The per-column chain (``pattern=None``,
the bw kernels) runs the same model at batch 4, the size of its golden
fixture. Tolerances: the fp32 stem's requantized codes within one code on
at most 0.1 % of entries (fp32 summation order); every later layer, fed
JAX's own intermediates, exactly; the logits within 1e-3 relative L2.
"""
import ast
import dataclasses
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
from repro.configs import cnn as jcfg
from repro.models.cnn import SparseCNN as JSparseCNN
from repro_torch import resolve_device
from repro_torch.configs import cnn as tcfg
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBWeight
from repro_torch.interop import flatten, params_from_numpy, unflatten
from repro_torch.launch import serve
from repro_torch.models.cnn import SparseCNN

ROOT = Path(__file__).resolve().parents[1]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def chain():
    return tp.jax_chain()


@pytest.fixture(scope="module")
def chain_bw():
    return tp.jax_chain(batch=tp.FIXTURE_BATCH, pattern=None)


def _port_model(tree, pattern="matrix"):
    cfg = dataclasses.replace(tcfg.smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                              convs_per_stage=2)
    return SparseCNN(cfg).load_state(params_from_numpy(tree, "cpu"))


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["sparse-cnn-tiny", "sparse-cnn-s"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(name, smoke):
    fn_t, fn_j = ((tcfg.smoke_cnn_config, jcfg.smoke_cnn_config) if smoke
                  else (tcfg.get_cnn_config, jcfg.get_cnn_config))
    t, j = fn_t(name), fn_j(name)
    for f in ("name", "in_channels", "image_size", "stage_channels", "convs_per_stage",
              "kernel_size", "num_classes"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.fmt.bz, t.fmt.nnz, t.fmt.group) == (j.fmt.bz, j.fmt.nnz, j.fmt.group)
    assert t.param_count() == j.param_count()
    for b in (1, 64):
        assert SparseCNN(t).flops(b) == JSparseCNN(j).flops(b)


def test_sparse_cnn_s_layers():
    """1 dense stem, 7 compressed convs (three of them stride 2), the head."""
    m = SparseCNN(tcfg.get_cnn_config("sparse-cnn-s"))
    layers = m.layers()
    assert [f"l{i}" for i in range(len(layers))] == [n for n, _ in m.named_children()]
    convs, head = layers[:-1], layers[-1]
    assert len(convs) == 8 and convs[0].fmt.is_dense
    assert all(c.fmt.nnz == 3 and c.fmt.group == "matrix" for c in convs[1:])
    assert sum(c.stride == (2, 2) for c in convs) == 3
    assert (head.in_features, head.out_features) == (512, 1000)
    assert 5.1e6 < m.cfg.param_count() < 5.3e6


def test_sparse_cnn_s_per_column_config_matches_reference():
    """``pattern=None``: every compressed layer keeps a pattern per output
    column, at the same widths and weights as the shared-pattern model."""
    t = tcfg.get_cnn_config("sparse-cnn-s", pattern=None)
    j = jcfg.get_cnn_config("sparse-cnn-s", pattern=None)
    assert (t.fmt.bz, t.fmt.nnz, t.fmt.group) == (j.fmt.bz, j.fmt.nnz, j.fmt.group) == (8, 3, None)
    assert t.param_count() == j.param_count() == tcfg.get_cnn_config("sparse-cnn-s").param_count()
    assert SparseCNN(t).flops(64) == JSparseCNN(j).flops(64)
    smoke = tcfg.smoke_cnn_config("sparse-cnn-s", pattern=None)
    m = SparseCNN(smoke).init(torch.Generator().manual_seed(0), "cpu").compress()
    for layer in m.layers()[1:]:
        w = layer.w
        n = w.shape[1]
        assert w.indices.shape == (w.shape[0] // 8, 3, n) and w.indices.is_contiguous()


# -------------------------------------------------------------- lifecycle


def test_lifecycle_converts_state_in_place():
    cfg = tcfg.smoke_cnn_config("sparse-cnn-tiny")
    m = SparseCNN(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert set(m.state()) == {f"l{i}" for i in range(len(m.layers()))}
    assert set(m.state()["l1"]) == {"w", "b"}
    w_before = m.l1.w
    assert m.constrain() is m and m.l1.w is not w_before
    m.compress()
    assert isinstance(m.l1.w, DBBWeight) and isinstance(m.l0.w, torch.Tensor)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        logits, stats = m(x, collect_act_stats=True)
    assert logits.shape == (4, 10) and len(stats) == len(m.layers())
    m.quantize(stats)
    assert isinstance(m.l1.w, QuantDBBWeight) and isinstance(m.l0.w, torch.Tensor)
    assert set(m.state()["l1"]) == {"w", "b", "aq"} and m.l0.aq is None
    assert m._int8_chain_ready(m.layers())
    inter = []
    with torch.no_grad():
        y = m(x, intermediates=inter)
    assert y.shape == (4, 10) and bool(torch.isfinite(y).all())
    assert [t.dtype for t in inter] == [torch.int8] * (len(inter) - 1) + [torch.float32]
    with pytest.raises(ValueError):
        m.quantize(stats[:-1])


def test_fp_forward_matches_reference():
    """The calibration pass: the same compressed fp32 params through both."""
    cfg = tp.chain_config()
    jm = JSparseCNN(cfg)
    rng = np.random.default_rng(3)
    params = jm.compress(tp.random_biases(jm.init(jax.random.PRNGKey(3)), rng))
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    jl, jst = jm.apply(params, jnp.asarray(x), collect_act_stats=True)
    tm = _port_model(tp.to_numpy(params))
    with torch.no_grad():
        tl, tst = tm(torch.from_numpy(x), collect_act_stats=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    for a, b in zip(tst, jst):
        assert (a.name, a.shape, a.macs) == (b.name, b.shape, b.macs)
        assert a.absmax == pytest.approx(b.absmax, rel=1e-5)
        assert a.zero_frac == pytest.approx(b.zero_frac, abs=1e-3)


# ------------------------------------------------------------------ chain


def test_chain_stem_codes_within_one(chain):
    m = _port_model(chain["params"])
    inter = []
    with torch.no_grad():
        m(torch.from_numpy(chain["input"]), intermediates=inter)
    got, want = inter[0].numpy().astype(np.int32), chain["intermediates"]["0"].astype(np.int32)
    assert inter[0].dtype == torch.int8
    d = np.abs(got - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_chain_layer_exact_on_reference_intermediates(chain, layer):
    """l1 int8 -> int8, l2 the stride-2 conv, l3 int8 -> fp32 into GAP."""
    m = _port_model(chain["params"])
    convs = m.layers()[:-1]
    out_scale = convs[layer + 1].aq if layer + 1 < len(convs) else None
    x = torch.from_numpy(chain["intermediates"][str(layer - 1)])
    with torch.no_grad():
        got = convs[layer].quant_serve(x, relu=True, out_scale=out_scale)
    want = chain["intermediates"][str(layer)]
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_head_exact_and_logits_close(chain):
    m = _port_model(chain["params"])
    with torch.no_grad():
        head = m.layers()[-1].quant_serve(torch.from_numpy(chain["pooled"]))
        logits = m(torch.from_numpy(chain["input"]))
    np.testing.assert_array_equal(head.numpy(), chain["logits"])
    assert logits.shape == (tp.CHAIN_BATCH, 10)
    assert rel_l2(logits.numpy(), chain["logits"]) <= 1e-3


# --------------------------------------------------- per-column chain


def test_chain_bw_stem_codes_within_one(chain_bw):
    m = _port_model(chain_bw["params"], pattern=None)
    assert m.l1.w.fmt.group is None and m.l1.w.indices.shape == (36, 3, 32)
    inter = []
    with torch.no_grad():
        m(torch.from_numpy(chain_bw["input"]), intermediates=inter)
    got = inter[0].numpy().astype(np.int32)
    d = np.abs(got - chain_bw["intermediates"]["0"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_chain_bw_layer_exact_on_reference_intermediates(chain_bw, layer):
    """Per-column l1 int8 -> int8, l2 stride 2, l3 int8 -> fp32 into GAP."""
    m = _port_model(chain_bw["params"], pattern=None)
    convs = m.layers()[:-1]
    out_scale = convs[layer + 1].aq if layer + 1 < len(convs) else None
    x = torch.from_numpy(chain_bw["intermediates"][str(layer - 1)])
    with torch.no_grad():
        got = convs[layer].quant_serve(x, relu=True, out_scale=out_scale)
    want = chain_bw["intermediates"][str(layer)]
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_bw_head_exact_and_logits_close(chain_bw):
    m = _port_model(chain_bw["params"], pattern=None)
    with torch.no_grad():
        head = m.layers()[-1].quant_serve(torch.from_numpy(chain_bw["pooled"]))
        logits = m(torch.from_numpy(chain_bw["input"]))
    np.testing.assert_array_equal(head.numpy(), chain_bw["logits"])
    assert logits.shape == (tp.FIXTURE_BATCH, 10)
    assert rel_l2(logits.numpy(), chain_bw["logits"]) <= 1e-3


# ---------------------------------------------------------------- fixture


def test_golden_fixture_is_current():
    """Regenerate the fixture from the JAX reference: it equals the
    committed file, entry by entry, and stays under 200 KB."""
    assert tp.FIXTURE.stat().st_size < 200_000
    fresh = flatten(tp.jax_chain(batch=tp.FIXTURE_BATCH))
    with np.load(tp.FIXTURE) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_golden_fixture_bw_is_current(chain_bw):
    """The per-column fixture is the JAX reference's batch-4 chain, entry
    by entry, under 200 KB."""
    assert tp.FIXTURE_BW.stat().st_size < 200_000
    fresh = flatten(chain_bw)
    with np.load(tp.FIXTURE_BW) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_golden_fixture_bw_through_the_port():
    with np.load(tp.FIXTURE_BW) as z:
        tree = unflatten(z)
    m = _port_model(tree["params"], pattern=None)
    assert isinstance(m.l1.w, QuantDBBWeight) and m.l1.w.fmt.group is None
    assert m.l3.w.indices.shape == (72, 3, 64) and m.l3.w.indices.is_contiguous()
    with torch.no_grad():
        logits = m(torch.from_numpy(tree["input"]))
    assert rel_l2(logits.numpy(), tree["logits"]) <= 1e-3


def test_golden_fixture_through_the_port():
    with np.load(tp.FIXTURE) as z:
        tree = unflatten(z)
    m = _port_model(tree["params"])
    assert isinstance(m.l1.w, QuantDBBWeight) and m.l1.w.values.dtype == torch.int8
    assert m.l1.w.fmt.group == "matrix" and isinstance(m.l0.w, torch.Tensor)
    with torch.no_grad():
        logits = m(torch.from_numpy(tree["input"]))
    assert rel_l2(logits.numpy(), tree["logits"]) <= 1e-3


def test_interop_group_encodings():
    tree = {"l0": {"w": {"values": np.zeros((2, 3, 4), np.float32),
                         "indices": np.zeros((2, 3, 4), np.int8), "bz": 8, "nnz": 3,
                         "group": None, "shape": np.array([16, 4])}}}
    back = unflatten(flatten(tree))
    w = params_from_numpy(back, "cpu")["l0"]["w"]
    assert isinstance(w, DBBWeight) and w.fmt.group is None and w.shape == (16, 4)
    back["l0"]["w"]["group"] = np.asarray("4")
    assert params_from_numpy(back, "cpu")["l0"]["w"].fmt.group == 4


# --------------------------------------------------------- entry points


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        serve.serve("sparse-cnn-tiny", smoke=True)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="card"):
        serve.serve("sparse-cnn-tiny", smoke=True, device="cpu")


def test_build_model_on_the_cpu_gives_a_calibrated_int8_chain():
    model, x = serve.build_model("sparse-cnn-tiny", calib_batch=2, device="cpu", smoke=True)
    assert model._int8_chain_ready(model.layers())
    assert all(float(m.aq) > 0 for m in model.layers()[1:])
    with torch.no_grad():
        assert model(x).shape == (2, 10)


@pytest.mark.parametrize("sparsity,nnz", [(0.625, 3), (0.5, 4)])
def test_build_model_per_column_on_the_cpu(sparsity, nnz):
    """``sparsity`` and ``pattern`` reach the config: a per-column int8
    chain whose weights keep a pattern per output column."""
    model, x = serve.build_model("sparse-cnn-tiny", calib_batch=2, device="cpu", smoke=True,
                                 sparsity=sparsity, pattern=None)
    assert (model.cfg.fmt.nnz, model.cfg.fmt.group) == (nnz, None)
    assert model._int8_chain_ready(model.layers())
    head = model.layers()[-1].w
    assert head.indices.shape == (head.shape[0] // 8, nnz, head.shape[1])
    with torch.no_grad():
        assert model(x).shape == (2, 10)


# ----------------------------------------------------------- import guard

_GUARD = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(len(names))
"""


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _GUARD, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
