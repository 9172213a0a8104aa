"""repro_torch.core.quant and act_sparsity held against the JAX package:
the same numpy inputs through both. Integer codes, scales and int32
accumulators equal exactly; fp32 results equal exactly too where both run
the same single-rounding ops (dequantize, the fused flush)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import act_sparsity as jact
from repro.core import quant as jq
from repro.core import vdbb as jv
from repro_torch.core import act_sparsity as tact
from repro_torch.core import quant as tq
from repro_torch.core import vdbb as tv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _weights(k, n, nnz, group, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jdw = jv.dbb_encode(jnp.asarray(w), jv.DBBFormat(8, nnz, group), prune=True)
    tdw = tv.dbb_encode(torch.from_numpy(w), tv.DBBFormat(8, nnz, group), prune=True)
    return jdw, tdw


def _act(m, k, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(m, k))).astype(np.float32)


def test_quantize_rounds_half_to_even_like_jnp():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0, -300.0, 0.49999997], np.float32)
    got = tq.quantize(torch.from_numpy(x), 1.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.quantize(jnp.asarray(x), 1.0)))
    assert got.tolist() == [0, 2, 2, 0, -2, 126, 127, -127, 0]


@pytest.mark.parametrize("scale", [0.0123, 0.5, 3.0])
def test_act_quantize_and_scales_match(scale):
    x = _act(16, 64, seed=int(scale * 100), scale=scale)
    s_j = jq.dynamic_act_scale(jnp.asarray(x))
    s_t = tq.dynamic_act_scale(torch.from_numpy(x))
    assert float(s_t) == float(s_j)
    np.testing.assert_array_equal(tq.quantize(torch.from_numpy(x), s_t).numpy(),
                                  np.asarray(jq.quantize(jnp.asarray(x), s_j)))
    q = tq.quantize(torch.from_numpy(x), s_t)
    np.testing.assert_array_equal(tq.dequantize(q, s_t).numpy(),
                                  np.asarray(jq.dequantize(jnp.asarray(q.numpy()), s_j)))


@pytest.mark.parametrize("nnz,group", [(3, "matrix"), (2, None), (4, 8)])
def test_quantize_dbb_matches_exactly(nnz, group):
    jdw, tdw = _weights(64, 32, nnz, group, seed=nnz)
    jqw, tqw = jq.quantize_dbb(jdw), tq.quantize_dbb(tdw)
    np.testing.assert_array_equal(tqw.values.numpy(), np.asarray(jqw.values))
    np.testing.assert_array_equal(tqw.scales.numpy(), np.asarray(jqw.scales))
    np.testing.assert_array_equal(tqw.indices.numpy(), np.asarray(jqw.indices))
    assert tqw.values.dtype == torch.int8 and tqw.scales.dtype == torch.float32
    assert tqw.nbytes_compressed() == jqw.nbytes_compressed()
    assert tdw.nbytes_compressed() == jdw.nbytes_compressed()
    assert tdw.nbytes_dense() == jdw.nbytes_dense()
    back_t, back_j = tq.dequantize_dbb(tqw), jq.dequantize_dbb(jqw)
    np.testing.assert_array_equal(back_t.values.numpy(), np.asarray(back_j.values))
    with pytest.raises(ValueError):
        tq.quantize_dbb(tqw.as_dbb())


def test_resolve_quant_input():
    x = _act(4, 16, seed=1)
    xq, s = tq.resolve_quant_input(torch.from_numpy(x), None)
    jxq, js = jq.resolve_quant_input(jnp.asarray(x), None)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert float(s) == float(js)
    codes, s2 = tq.resolve_quant_input(xq, 0.25)
    assert codes is xq and float(s2) == 0.25
    with pytest.raises(ValueError, match="int8-resident"):
        tq.resolve_quant_input(xq, None)


def test_act_stats_and_calibration_scale():
    x = np.maximum(_act(8, 32, seed=4, scale=3.0), 0.0)
    st_t = tact.measure_activation(torch.from_numpy(x), name="t", macs=10)
    st_j = jact.measure_activation(jnp.asarray(x), name="t", macs=10)
    assert (st_t.absmax, st_t.zero_frac, st_t.shape, st_t.numel, st_t.macs) == (
        st_j.absmax, pytest.approx(st_j.zero_frac), st_j.shape, st_j.numel, st_j.macs)
    assert st_t.sparsity == st_t.zero_frac and st_t.density == 1.0 - st_t.zero_frac
    assert tq.act_scale_from_stats(st_t) == jq.act_scale_from_stats(st_j)
    with pytest.raises(ValueError):
        tq.act_scale_from_stats(tact.measure_activation(torch.zeros(4, 8)))


@pytest.mark.parametrize("gather", [False, True])
def test_quant_matmul_refs_match(gather):
    jdw, tdw = _weights(64, 24, 3, "matrix", seed=9)
    jqw, tqw = jq.quantize_dbb(jdw), tq.quantize_dbb(tdw)
    a = _act(10, 64, seed=10)
    s = float(jq.dynamic_act_scale(jnp.asarray(a)))
    aq = tq.quantize(torch.from_numpy(a), s)
    jfn, tfn = ((jq.quant_matmul_gather_ref, tq.quant_matmul_gather_ref) if gather
                else (jq.quant_matmul_ref, tq.quant_matmul_ref))
    np.testing.assert_array_equal(tfn(aq, tqw, s).numpy(),
                                  np.asarray(jfn(jnp.asarray(aq.numpy()), jqw, s)))


def test_int_matmul_ref_is_exact_at_the_extremes():
    """|acc| up to K·127² stays exact in int32 (the card's float64 path is
    exact below 2**53)."""
    k = 4608
    aq = torch.full((2, k), 127, dtype=torch.int8)
    wq = torch.full((k, 3), -127, dtype=torch.int8)
    acc = tq.int_matmul_ref(aq, wq)
    assert acc.dtype == torch.int32 and int(acc[0, 0]) == -k * 127 * 127
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(jq.int_matmul_ref(jnp.asarray(aq.numpy()), jnp.asarray(wq.numpy()))))


@pytest.mark.parametrize("stride", [1, 2])
def test_quant_conv_ref_matches(stride):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 7, 7, 16)).astype(np.float32)
    w = rng.normal(size=(3, 3, 16, 8)).astype(np.float32)
    jqw = jq.quantize_dbb(jv.dbb_encode_conv(jnp.asarray(w), jv.DBBFormat(8, 3, "matrix"), prune=True))
    tqw = tq.quantize_dbb(tv.dbb_encode_conv(torch.from_numpy(w), tv.DBBFormat(8, 3, "matrix"), prune=True))
    s = float(jq.dynamic_act_scale(jnp.asarray(x)))
    xq = tq.quantize(torch.from_numpy(x), s)
    got = tq.quant_conv_ref(xq, tqw, 3, 3, s, stride=stride)
    want = jq.quant_conv_ref(jnp.asarray(xq.numpy()), jqw, 3, 3, s, stride=stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
