"""The port's kernel layer held against the JAX package.

Every ``repro_torch.kernels.ops`` entry point, called with CPU tensors,
runs its kernel's plain PyTorch version. That version must match the JAX
Pallas kernel (``interpret=True``, as the JAX package's own tests run it on
the CPU) and the port's ``ref.py``: int8 and int32 results exactly, fp32
within rtol = atol = 1e-5 (summation order differs). Requantized codes
from an fp32 accumulator may differ by one code on at most 0.1 % of the
entries, for the same reason.

A wrapper given a tensor that is not on the CPU launches its CUDA kernel or
raises; it never takes the plain version. Here that is shown on the
``meta`` device; ``test_torch_cuda.py`` holds each CUDA kernel against its
plain version on a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core import vdbb as jv
from repro.kernels import core as jcore
from repro.kernels import ops as jops
from repro.kernels import vdbb_im2col_conv as jconv
from repro.kernels import vdbb_matmul as jvm
from repro_torch.core import quant as tq
from repro_torch.core import vdbb as tv
from repro_torch.kernels import core as tcore
from repro_torch.kernels import im2col_conv as stem_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vdbb_im2col_conv as conv_k
from repro_torch.kernels import vdbb_matmul as head_k
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
# per-column and grouped formats at the paper's densities (bw kernels)
BW_CASES = [(group, nnz) for group in (None, 4) for nnz in (1, 3, 8)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _assert_codes_close(got, want):
    """int8 codes from an fp32 accumulator: within one code on <= 0.1 %."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _matmul_case(m, k, n, nnz, group, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    jw = jv.dbb_encode(jnp.asarray(w), jv.DBBFormat(8, nnz, group), prune=True)
    tw = tv.dbb_encode(_t(w), tv.DBBFormat(8, nnz, group), prune=True)
    return a, bias, jw, tw


def _conv_case(n, h, c, f, nnz, group, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    w = rng.normal(size=(3, 3, c, f)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    if c % 8:  # a dense stem: C is not blockable
        return x, w, bias, None, None
    jw = jv.dbb_encode_conv(jnp.asarray(w), jv.DBBFormat(8, nnz, group), prune=True)
    tw = tv.dbb_encode_conv(_t(w), tv.DBBFormat(8, nnz, group), prune=True)
    return x, w, bias, jw, tw


# ------------------------------------------------------------ host pieces


@pytest.mark.parametrize("h,k,s,pad", [(64, 3, 2, "SAME"), (64, 3, 1, "SAME"), (9, 3, 2, "SAME"),
                                       (8, 3, 1, "VALID"), (8, 3, 2, ((1, 2), (0, 1)))])
def test_conv_geometry_matches(h, k, s, pad):
    assert tcore.conv_geometry(h, h, k, k, s, pad) == jcore.conv_geometry(h, h, k, k, s, pad)


def test_stride2_same_pads_at_the_end():
    assert tcore.conv_geometry(64, 64, 3, 3, 2, "SAME")[1] == ((0, 1), (0, 1))


@pytest.mark.parametrize("kind", ["int_raw", "int_relu", "int_scale", "fp_none", "requant"])
def test_epilogue_output_dtype_rules(kind):
    ops_dtype = torch.float32 if kind == "fp_none" else torch.int8
    kw = {"int_raw": {}, "int_relu": dict(relu=True), "int_scale": dict(scales=0.5),
          "fp_none": {}, "requant": dict(scales=0.5, out_scale=0.1)}[kind]
    ep = tcore.epilogue_plan(4, "cpu", acc_dtype=tcore.acc_dtype_for(ops_dtype), **kw)
    _, _, _, jout = jcore.epilogue_plan(
        4, 4, acc_dtype=jcore.acc_dtype_for(jnp.float32 if kind == "fp_none" else jnp.int8),
        in_dtype=jnp.float32 if kind == "fp_none" else jnp.int8, **kw)
    assert str(ep.out_dtype).split(".")[-1] == jnp.dtype(jout).name
    if kind == "requant":
        assert ep.out_scale.shape == (4,) and float(ep.out_scale[3]) == pytest.approx(0.1)


def test_epilogue_plain_flush_matches_reference():
    rng = np.random.default_rng(3)
    acc = rng.integers(-40000, 40000, size=(16, 12)).astype(np.int32)
    scale = (rng.random(12) * 1e-3).astype(np.float32)
    bias = rng.normal(size=12).astype(np.float32)
    from repro.kernels import ref as jref

    for out_scale in (None, 0.05):
        ep = tcore.epilogue_plan(12, "cpu", scales=_t(scale), bias=_t(bias), relu=True,
                                 out_scale=out_scale, acc_dtype=torch.int32)
        got = tcore.apply_epilogue(_t(acc), ep)
        want = jref.quant_epilogue_ref(jnp.asarray(acc), jnp.asarray(scale), bias=jnp.asarray(bias),
                                       relu=True, out_scale=out_scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tref.quant_epilogue_ref(_t(acc), _t(scale), bias=_t(bias), relu=True,
                                    out_scale=out_scale).numpy(), np.asarray(want))


NONFINITE = np.array([np.nan, -np.inf, np.inf, -0.0, 0.0, 1.5, -2.5, 2.5, 1e30, -1e30, 300.0,
                      -0.2], np.float32)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("out_scale", [None, 0.5, float("nan")])
@pytest.mark.parametrize("poison", ["acc", "bias", "scale"])
def test_epilogue_plain_flush_nonfinite_matches_reference(relu, out_scale, poison):
    """NaN, ±inf and -0 through the plain flush as the JAX oracle flushes
    them: NaN passes ReLU, a NaN quotient is code 0, ±inf clips to ±127, -0
    is 0; in the accumulator (fp32, as the stem's), a bias column or a
    scale column (NaN, ±inf)."""
    from repro.kernels import ref as jref

    n = NONFINITE.size
    acc = np.tile(NONFINITE, (n, 1)) if poison == "acc" else np.tile(NONFINITE[::-1], (n, 1)).T
    scale = np.ones(n, np.float32)
    bias = np.zeros(n, np.float32)
    if poison == "bias":
        bias = NONFINITE.copy()
    elif poison == "scale":
        scale = np.where(np.isfinite(NONFINITE), 0.75, NONFINITE).astype(np.float32)
    acc = np.ascontiguousarray(acc, np.float32)
    ep = tcore.epilogue_plan(n, "cpu", scales=_t(scale), bias=_t(bias), relu=relu,
                             out_scale=out_scale, acc_dtype=torch.float32)
    got = tcore.apply_epilogue(_t(acc), ep).numpy()
    want = np.asarray(jref.quant_epilogue_ref(jnp.asarray(acc), jnp.asarray(scale),
                                              bias=jnp.asarray(bias), relu=relu,
                                              out_scale=out_scale))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)  # NaN equals NaN, -0 equals 0
    if out_scale is not None:
        assert not got[np.isnan(want.astype(np.float32))].any()


def test_quantize_maps_nan_to_code_zero():
    """The head's input quantize: NaN is code 0 and ±inf ±127, as the JAX
    package's quantize gives them."""
    from repro.core import quant as jquant

    got = tq.quantize(_t(NONFINITE), 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jquant.quantize(jnp.asarray(NONFINITE), 0.5)))
    assert got[0] == 0 and got[1] == -127 and got[2] == 127


# ------------------------------------------------------------ vdbb_matmul


@pytest.mark.parametrize("m,n,nnz,group,epi", [(16, 24, 3, "matrix", False), (8, 24, 3, "matrix", True),
                                               (5, 16, 2, None, True), (16, 16, 4, 8, False)])
def test_vdbb_matmul_fp32(m, n, nnz, group, epi):
    a, bias, jw, tw = _matmul_case(m, 64, n, nnz, group, seed=m + n + nnz)
    kw = dict(bias=bias, relu=True) if epi else {}
    got = tops.vdbb_matmul(_t(a), tw, **{k: (_t(v) if k == "bias" else v) for k, v in kw.items()})
    want = jops.vdbb_matmul(jnp.asarray(a), jw, interpret=True,
                            **{k: (jnp.asarray(v) if k == "bias" else v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tv.dbb_matmul_ref(_t(a), tw)
    if epi:
        plain = torch.relu(plain + _t(bias))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("group", ["matrix", None])
def test_vdbb_matmul_int8_raw_accumulator(group):
    a, _, jw, tw = _matmul_case(16, 64, 24, 3, group, seed=5)
    tqw = tq.quantize_dbb(tw)
    aq = tq.quantize(_t(a), tq.dynamic_act_scale(_t(a)))
    got = tops.vdbb_matmul(aq, tqw.as_dbb())
    want = jops.vdbb_matmul(_j(aq), jq.quantize_dbb(jw).as_dbb(), interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = tqw.indices[:, :, 0] if group == "matrix" else tqw.indices
    np.testing.assert_array_equal(
        got.numpy(), tref.vdbb_matmul_int_ref(aq, tqw.values, idx, tqw.fmt).numpy())


@pytest.mark.parametrize("m,requant,int8_in", [(8, False, False), (3, True, True), (16, True, False)])
def test_quant_matmul(m, requant, int8_in):
    a, bias, jw, tw = _matmul_case(m, 64, 40, 3, "matrix", seed=m)
    jqw, tqw = jq.quantize_dbb(jw), tq.quantize_dbb(tw)
    s = float(jq.dynamic_act_scale(jnp.asarray(a)))
    x = tq.quantize(_t(a), s) if int8_in else _t(a)
    kw = dict(relu=True, out_scale=0.03 if requant else None)
    got = tops.quant_matmul(x, tqw, s, bias=_t(bias), **kw)
    want = jops.quant_matmul(_j(x), jqw, s, bias=jnp.asarray(bias), interpret=True, **kw)
    assert got.dtype == (torch.int8 if requant else torch.float32)
    if requant:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xq = tq.quantize(_t(a), s)
    acc = tq.int_matmul_ref(xq, tv.dbb_decode(tqw.as_dbb()))
    plain = tref.quant_epilogue_ref(acc, s * tqw.scales, bias=_t(bias), **kw)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def _per_column_indices(jw):
    """JAX's bw kernels take one position row per column: a grouped
    weight's (nb, nnz, N/g) indices repeated g times, as ``ops`` does."""
    g = jw.values.shape[2] // jw.indices.shape[2]
    return jnp.repeat(jw.indices, g, axis=2)


def _assert_bw_matches(run_port, run_jax, a, tw, jw, bias):
    """One bw kernel at three instantiations against JAX's bw Pallas kernel
    (per-column indices) and the port's own plain version (its indices in
    place): fp32 with bias and ReLU within 1e-5, int8 raw int32 exactly,
    int8 requantized codes exactly."""
    got = run_port(_t(a), tw.values, tw.indices, tw.fmt, bias=_t(bias), relu=True)
    want = run_jax(jnp.asarray(a), jw.values, _per_column_indices(jw), jw.fmt,
                   bias=jnp.asarray(bias), relu=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tqw, jqw = tq.quantize_dbb(tw), jq.quantize_dbb(jw)
    s = tq.dynamic_act_scale(_t(a))
    aq = tq.quantize(_t(a), s)
    got = run_port(aq, tqw.values, tqw.indices, tqw.fmt)
    want = run_jax(_j(aq), jqw.values, _per_column_indices(jqw), jqw.fmt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(relu=True, out_scale=0.05)
    got = run_port(aq, tqw.values, tqw.indices, tqw.fmt, scales=s * tqw.scales,
                   bias=_t(bias), **kw)
    want = run_jax(_j(aq), jqw.values, _per_column_indices(jqw), jqw.fmt,
                   scales=_j(s * tqw.scales), bias=jnp.asarray(bias), **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return tqw, aq


@pytest.mark.parametrize("group,nnz", BW_CASES)
def test_vdbb_matmul_bw_matches_reference(group, nnz):
    a, bias, jw, tw = _matmul_case(16, 64, 24, nnz, group, seed=70 + nnz)
    assert tw.indices.shape == (8, nnz, 24 // tw.fmt.group_size(24))
    tqw, aq = _assert_bw_matches(
        head_k.vdbb_matmul_bw,
        lambda *args, **kw: jvm.vdbb_matmul_bw(*args, interpret=True, **kw), a, tw, jw, bias)
    np.testing.assert_array_equal(
        head_k.vdbb_matmul_bw(aq, tqw.values, tqw.indices, tqw.fmt).numpy(),
        tref.vdbb_matmul_int_ref(aq, tqw.values, tqw.indices, tqw.fmt).numpy())


# ------------------------------------------------------ fused_im2col_conv


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"), (1, "VALID")])
def test_fused_im2col_conv_fp32(stride, padding):
    x, w, bias, _, _ = _conv_case(2, 9, 3, 16, 3, "matrix", seed=stride)
    got = tops.fused_im2col_conv(_t(x), _t(w), bias=_t(bias), relu=True, stride=stride,
                                 padding=padding)
    want = jops.fused_im2col_conv(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias),
                                  relu=True, stride=stride, padding=padding, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    conv = tref.conv_lax_ref(_t(x), _t(w), stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), torch.relu(conv + _t(bias)).numpy(), **TOL)
    np.testing.assert_allclose(
        tref.im2col_conv_ref(_t(x), _t(w), stride=stride, padding=padding).numpy(),
        conv.numpy(), **TOL)


def test_fused_im2col_conv_stem_requantizes_to_int8():
    """The int8-resident chain's stem: fp32 conv, bias, ReLU, int8 codes."""
    x, w, bias, _, _ = _conv_case(4, 16, 3, 32, 3, "matrix", seed=11)
    kw = dict(relu=True, out_scale=0.02, stride=1, padding="SAME")
    got = tops.fused_im2col_conv(_t(x), _t(w), bias=_t(bias), **kw)
    want = jops.fused_im2col_conv(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias),
                                  interpret=True, **kw)
    assert got.dtype == torch.int8
    _assert_codes_close(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_im2col_conv_int8_raw_accumulator(stride):
    rng = np.random.default_rng(stride + 20)
    xq = rng.integers(-127, 128, size=(2, 8, 8, 8)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(3, 3, 8, 16)).astype(np.int8)
    got = tops.fused_im2col_conv(_t(xq), _t(wq), stride=stride)
    want = jops.fused_im2col_conv(jnp.asarray(xq), jnp.asarray(wq), stride=stride, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ sparse_conv


@pytest.mark.parametrize("group,stride,epi", [("matrix", 1, True), ("matrix", 2, False),
                                              (None, 2, True)])
def test_sparse_conv_fp32(group, stride, epi):
    x, _, bias, jw, tw = _conv_case(2, 8, 16, 16, 3, group, seed=stride + 30)
    kw = dict(relu=True) if epi else {}
    tb, jb = (_t(bias), jnp.asarray(bias)) if epi else (None, None)
    got = tops.sparse_conv(_t(x), tw, 3, 3, bias=tb, stride=stride, **kw)
    want = jops.sparse_conv(jnp.asarray(x), jw, 3, 3, bias=jb, stride=stride, bf=8,
                            interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tref.sparse_conv_ref(_t(x), tw, 3, 3, stride=stride)
    if epi:
        plain = torch.relu(plain + tb)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("group,stride", [("matrix", 1), ("matrix", 2), (None, 1)])
def test_sparse_conv_int8_raw_accumulator(group, stride):
    x, _, _, jw, tw = _conv_case(2, 8, 16, 16, 3, group, seed=stride + 40)
    tqw, jqw = tq.quantize_dbb(tw), jq.quantize_dbb(jw)
    xq = tq.quantize(_t(x), tq.dynamic_act_scale(_t(x)))
    got = tops.sparse_conv(xq, tqw.as_dbb(), 3, 3, stride=stride)
    want = jops.sparse_conv(_j(xq), jqw.as_dbb(), 3, 3, stride=stride, bf=8, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tref.sparse_conv_int_ref(xq, tqw.as_dbb(), 3, 3, stride=stride).numpy())


@pytest.mark.parametrize("stride,requant", [(1, True), (2, True), (1, False)])
def test_quant_conv_int8_resident(stride, requant):
    """int8 codes in, the next layer's int8 codes (or fp32) out: exact."""
    x, _, bias, jw, tw = _conv_case(2, 8, 16, 24, 3, "matrix", seed=stride + 50)
    tqw, jqw = tq.quantize_dbb(tw), jq.quantize_dbb(jw)
    s = float(tq.dynamic_act_scale(_t(x)))
    xq = tq.quantize(_t(x), s)
    kw = dict(relu=True, out_scale=0.04 if requant else None, stride=stride)
    got = tops.quant_conv(xq, tqw, 3, 3, s, bias=_t(bias), **kw)
    want = jops.quant_conv(_j(xq), jqw, 3, 3, s, bias=jnp.asarray(bias), bf=8,
                           interpret=True, **kw)
    assert got.dtype == (torch.int8 if requant else torch.float32)
    if requant:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:  # jit may contract the flush's multiply and add into one FMA
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    acc = tref.sparse_conv_int_ref(xq, tqw.as_dbb(), 3, 3, stride=stride)
    plain = tref.quant_epilogue_ref(acc, s * tqw.scales, bias=_t(bias), relu=True,
                                    out_scale=kw["out_scale"])
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("group,nnz,stride", [(g, nnz, 1 + i % 2)
                                              for i, (g, nnz) in enumerate(BW_CASES)])
def test_vdbb_im2col_conv_bw_matches_reference(group, nnz, stride):
    """Each (group, nnz) once, strides 1 and 2 taking turns."""
    x, _, bias, jw, tw = _conv_case(2, 8, 16, 16, nnz, group, seed=80 + nnz + stride)
    tqw, xq = _assert_bw_matches(
        lambda *args, **kw: conv_k.vdbb_im2col_conv_bw(*args, 3, 3, stride=stride, **kw),
        lambda *args, **kw: jconv.vdbb_im2col_conv_bw(*args, 3, 3, stride=stride, bf=8,
                                                      interpret=True, **kw),
        x, tw, jw, bias)
    np.testing.assert_array_equal(
        conv_k.vdbb_im2col_conv_bw(xq, tqw.values, tqw.indices, tqw.fmt, 3, 3,
                                   stride=stride).numpy(),
        tref.sparse_conv_int_ref(xq, tqw.as_dbb(), 3, 3, stride=stride).numpy())


@pytest.mark.parametrize("group", [None, 4])
@pytest.mark.parametrize("stride,requant", [(1, True), (2, True), (1, False)])
def test_quant_conv_int8_resident_per_column(group, stride, requant):
    """The per-column chain's conv: int8 codes in, the next layer's codes
    (or fp32 into GAP) out, against JAX's ``quant_conv`` (bw kernel)."""
    x, _, bias, jw, tw = _conv_case(2, 8, 16, 24, 3, group, seed=stride + 90)
    tqw, jqw = tq.quantize_dbb(tw), jq.quantize_dbb(jw)
    s = float(tq.dynamic_act_scale(_t(x)))
    xq = tq.quantize(_t(x), s)
    kw = dict(relu=True, out_scale=0.04 if requant else None, stride=stride)
    got = tops.quant_conv(xq, tqw, 3, 3, s, bias=_t(bias), **kw)
    want = jops.quant_conv(_j(xq), jqw, 3, 3, s, bias=jnp.asarray(bias), bf=8,
                           interpret=True, **kw)
    assert got.dtype == (torch.int8 if requant else torch.float32)
    if requant:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:  # jit may contract the flush's multiply and add into one FMA
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------- off the CPU: kernel or raise


@pytest.mark.parametrize("which,group", [("conv", None), ("conv", 4), ("head", None),
                                         ("head", 4)])
def test_per_column_weight_off_the_cpu_reaches_the_bw_kernel(which, group, monkeypatch):
    """Dispatch hands a per-column or grouped weight to the bw kernel's
    wrapper with its own indices, (nb, nnz, N/g) as stored: nothing is
    repeated per column, and nothing raises NotImplementedError."""
    seen = {}

    def record(*args, **kw):
        seen["indices"] = args[2]
        return "launched"

    meta = torch.device("meta")
    if which == "conv":
        x, _, _, _, w = _conv_case(1, 8, 16, 16, 3, group, seed=60)
        monkeypatch.setattr(conv_k, "vdbb_im2col_conv_bw", record)
        w = w.to(meta)
        assert tops.sparse_conv(_t(x).to(meta), w, 3, 3) == "launched"
    else:
        a, _, _, w = _matmul_case(4, 64, 16, 3, group, seed=61)
        monkeypatch.setattr(head_k, "vdbb_matmul_bw", record)
        w = w.to(meta)
        assert tops.vdbb_matmul(_t(a).to(meta), w) == "launched"
    assert seen["indices"] is w.indices
    assert seen["indices"].shape[2] == 16 // w.fmt.group_size(16)


@pytest.mark.parametrize("which", ["stem", "conv", "head", "conv_bw", "head_bw", "head_grouped"])
def test_wrapper_never_runs_plain_version_off_the_cpu(which, monkeypatch):
    """A tensor off the CPU reaches the kernel's operand checks (which
    refuse a non-CUDA device), never the plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version ran for a tensor off the CPU")

    monkeypatch.setattr(stem_k, "im2col_conv_plain", boom)
    monkeypatch.setattr(conv_k, "vdbb_im2col_conv_tc_plain", boom)
    monkeypatch.setattr(conv_k, "vdbb_im2col_conv_bw_plain", boom)
    monkeypatch.setattr(head_k, "vdbb_matmul_tc_plain", boom)
    monkeypatch.setattr(head_k, "vdbb_matmul_bw_plain", boom)
    group = {"conv_bw": None, "head_bw": None, "head_grouped": 4}.get(which, "matrix")
    x, w, _, _, tw = _conv_case(1, 8, 16, 16, 3, group, seed=62)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "stem":
            tops.fused_im2col_conv(_t(x).to(meta), _t(w).to(meta))
        elif which.startswith("conv"):
            tops.sparse_conv(_t(x).to(meta), tw.to(meta), 3, 3)
        else:
            a, _, _, mw = _matmul_case(4, 64, 16, 3, group, seed=63)
            tops.vdbb_matmul(_t(a).to(meta), mw.to(meta))


def test_launch_counters_start_at_zero_and_reset():
    from repro_torch.kernels import build

    names = {"im2col_conv", "vdbb_conv_tc", "vdbb_matmul_tc", "vdbb_conv_bw", "vdbb_matmul_bw"}
    assert set(build.KERNELS) == names
    assert {build.KERNELS[n].source for n in names} == set(build.SOURCES)
    for k in build.KERNELS.values():
        k.counts = dict.fromkeys(k.counts, 5)
    build.reset_launches()
    # the tc matmul's bf16 instantiation and its wgmma core, the tc conv's
    # residual flush and the stem source's max-pool count apart, each under
    # its own name
    variants = {"vdbb_matmul_tc_bf16": "vdbb_matmul_tc", "vdbb_matmul_tc_wgmma": "vdbb_matmul_tc",
                "vdbb_conv_tc_residual": "vdbb_conv_tc", "im2col_conv_maxpool": "im2col_conv"}
    assert build.launch_counts() == dict.fromkeys(names | set(variants), 0)
    for v, k in variants.items():
        assert build.kernel_of(v) is build.KERNELS[k]
    for k in build.KERNELS.values():
        assert k.replaces.startswith("src/repro/kernels/") and (build.CSRC / k.source).exists()


def test_malformed_indices_are_refused():
    a, _, _, tw = _matmul_case(4, 64, 16, 3, "matrix", seed=64)
    with pytest.raises(ValueError, match="indices"):
        head_k.vdbb_matmul_tc(_t(a), tw.values, tw.indices[:-1, :, 0], tw.fmt)
    x, _, _, _, cw = _conv_case(1, 8, 16, 16, 3, "matrix", seed=65)
    with pytest.raises(ValueError, match="indices"):
        conv_k.vdbb_im2col_conv_tc(_t(x), cw.values, cw.indices[:, :2, 0], cw.fmt, 3, 3)


# --------------------------- host rules of the int8 tensor-core GEMM (os_mma)


@pytest.mark.parametrize("m,rows", [(1, 64), (8, 64), (64, 64), (65, 128), (4096, 128),
                                    (262144, 128)])
def test_mma_plan_tile_rows_by_m(m, rows):
    """The head and the deep layers at batch 1 (M <= 64) take the 64-row
    tile; larger M the 128-row one."""
    assert tcore.mma_plan("k", m, 576, 64, 0).tile_rows == rows


@pytest.mark.parametrize("run,ptr,chunk", [(64, 0, 16), (512, 4096, 16), (32, 16, 16),
                                           (24, 0, 8), (8, 0, 8), (64, 8, 8), (16, 24, 8)])
def test_mma_plan_chunk_by_run_and_alignment(run, ptr, chunk):
    """16-byte chunks when the run of K (C, or a matrix's K) is a multiple
    of 16 and the operand 16-byte aligned; 8 bytes otherwise."""
    assert tcore.mma_plan("k", 100, 9 * run, run, ptr).chunk == chunk


@pytest.mark.parametrize("run,ptr", [(12, 0), (4, 0), (64, 4), (64, 1)])
def test_mma_plan_refuses_what_the_kernel_cannot_copy(run, ptr):
    with pytest.raises(ValueError, match="chunks"):
        tcore.mma_plan("vdbb_conv_bw", 100, 9 * run, run, ptr)


def test_mma_plan_k_limit():
    """The int32 sum of K products of ±127 codes is exact up to MMA_MAX_K."""
    assert tcore.MMA_MAX_K * 127 * 127 < 2**31 <= (tcore.MMA_MAX_K + 1) * 127 * 127
    assert tcore.mma_plan("k", 64, tcore.MMA_MAX_K, 8, 0).chunk == 8
    with pytest.raises(ValueError, match="overflow"):
        tcore.mma_plan("vdbb_matmul_bw", 64, tcore.MMA_MAX_K + 1, 8, 0)


@pytest.mark.parametrize("switch", ["NO_A", "NO_GATHER", "NO_B", "NO_MMA"])
def test_mma_ablation_switches_find_their_anchor(switch, tmp_path, monkeypatch):
    """Each switch of the ablation tool applies to the core as it stands:
    its anchor is in os_mma.cuh exactly once, and the switched copy lacks it."""
    from repro_torch.kernels import build, mma_ablation

    anchor, _ = mma_ablation.SWITCHES[switch]
    assert (build.CSRC / "os_mma.cuh").read_text().count(anchor) == 1
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    out = mma_ablation.variant_sources("probe", (switch,))
    assert anchor not in (out / "os_mma.cuh").read_text()
    assert {p.name for p in out.iterdir()} == {p.name for p in build.CSRC.iterdir()}


def test_mma_ablation_variants_each_start_from_the_sources(tmp_path, monkeypatch):
    """The tool points the build at each variant's copy in turn; every
    variant is still cut from the committed sources, not from the last copy."""
    from repro_torch.kernels import build, mma_ablation

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    csrc = build.CSRC
    monkeypatch.setattr(build, "CSRC", mma_ablation.variant_sources("first", ("NO_B",), csrc))
    out = mma_ablation.variant_sources("second", ("NO_A",), csrc)
    text = (out / "os_mma.cuh").read_text()
    assert mma_ablation.SWITCHES["NO_B"][0] in text
    assert mma_ablation.SWITCHES["NO_A"][0] not in text


# ------------------- host rules of the tc head's gather and the stem's paths


@pytest.mark.parametrize("m,rows", [(1, 64), (8, 64), (64, 64), (67, 128), (130, 128)])
def test_mma_gather_plan_at_the_heads_shapes(m, rows):
    """The tc head (K = 512, K_c = 192 at nnz = 3) at request batches 1, 8
    and 64 takes the 64-row tile; A is gathered byte by byte on the core's
    8-byte instance with no alignment condition."""
    plan = tcore.mma_gather_plan("vdbb_matmul_tc", m, 192)
    assert (plan.tile_rows, plan.chunk, plan.gathered) == (rows, 8, True)


def test_mma_gather_plan_refuses_kc_above_the_exact_limit():
    assert tcore.mma_gather_plan("k", 64, tcore.MMA_MAX_K).chunk == 8
    with pytest.raises(ValueError, match="overflow"):
        tcore.mma_gather_plan("vdbb_matmul_tc", 64, tcore.MMA_MAX_K + 1)


@pytest.mark.parametrize("nb,refused", [(16643, False), (16644, True)])
def test_tc_head_wrapper_refuses_kc_above_the_exact_limit(nb, refused):
    """An int8 tc product off the CPU whose compressed K (nb * nnz, here
    nnz = bz = 8) exceeds MMA_MAX_K = 133 144 is refused before any launch;
    one at the limit passes the plan and reaches the operand checks."""
    assert tcore.MMA_MAX_K == 8 * 16643
    meta = dict(dtype=torch.int8, device="meta")
    a, values = torch.empty(1, 8 * nb, **meta), torch.empty(nb, 8, 16, **meta)
    indices = torch.empty(nb, 8, **meta)
    with pytest.raises(ValueError, match="overflow" if refused else "CUDA"):
        head_k.vdbb_matmul_tc(a, values, indices, tv.DBBFormat(8, 8, "matrix"))


# ------------------------------- host rules of the tc matmul's wgmma core

# (m, k, nnz, A's address, staged) -> the core the rule takes (and its rows)
WGMMA_RULE = [
    ((1024, 4608, 3, 0, True), ("wgmma", 128)),     # starcoder2-7b's prefill, staged
    ((2048, 18432, 3, 256, True), ("wgmma", 128)),
    ((tcore.WGMMA_MIN_M, 4608, 3, 0, True), ("wgmma", 128)),
    ((tcore.WGMMA_MIN_M - 1, 4608, 3, 0, True), ("mma", 64)),
    ((64, 512, 3, 0, True), ("mma", 64)),           # the CNN head's rows, decode rows
    ((16, 4608, 3, 0, True), ("mma", 64)),
    ((1024, 4608, 3, 0, False), ("mma", 128)),      # unstaged: no K-major copy
    ((1024, 4608, 3, 8, True), ("mma", 128)),       # A not 16-byte aligned
    ((1024, 4600, 3, 0, True), ("mma", 128)),       # a row of A not a multiple of 16 bytes
    ((1024, 4608, 8, 0, True), ("wgmma", 128)),
    ((1024, 4608, 1, 0, True), ("wgmma", 128)),
]


@pytest.mark.parametrize("case,want", WGMMA_RULE)
def test_matmul_tc_plan_takes_the_wgmma_core_by_rows_staging_and_alignment(case, want):
    """The tc matmul's int8 rule: the wgmma core for a staged product at
    WGMMA_MIN_M rows or more whose A is 16-byte aligned with K % 16 == 0;
    os_mma.cuh at its own rule's rows otherwise."""
    m, k, nnz, ptr, staged = case
    plan = tcore.matmul_tc_plan("vdbb_matmul_tc", m, 4608, k, 8, nnz, ptr, staged=staged)
    core = "wgmma" if isinstance(plan, tcore.WgmmaPlan) else "mma"
    assert (core, plan.tile_rows) == want
    if core == "mma":
        assert plan == tcore.mma_gather_plan("vdbb_matmul_tc", m, k // 8 * nnz)


@pytest.mark.parametrize("nnz,stages", [(1, 4), (2, 4), (3, 4), (4, 3), (5, 3), (8, 2)])
def test_wgmma_ring_by_nnz(nnz, stages):
    """The ring as deep as shared memory holds (at most 4), as
    os_mma_sm90.cuh's Tile sizes it: a stage's muxed A and B grow with nnz."""
    assert tcore.wgmma_stages(nnz) == stages
    plan = tcore.matmul_tc_plan("k", 1024, 4608, 4608, 8, nnz, 0, staged=True)
    assert plan == tcore.WgmmaPlan(128, 128, stages)


def test_matmul_tc_plan_choices_override_the_rule():
    """A choice (a plan's, or the registry's) names the core: wgmma where the
    shape and A fit it, else refused; tile rows keep os_mma.cuh even where
    the rule would take wgmma."""
    plan = tcore.matmul_tc_plan("k", 64, 4608, 4608, 8, 3, 0, staged=False,
                                choice=tcore.WGMMA_CHOICE)
    assert isinstance(plan, tcore.WgmmaPlan) and plan.tile_rows == 128
    plan = tcore.matmul_tc_plan("k", 1024, 4608, 4608, 8, 3, 0, staged=True,
                                choice={"tile_rows": 64})
    assert plan == tcore.MmaPlan(64, 8, gathered=True)
    for k, ptr, bz in ((4608, 4, 8), (4600, 0, 8), (4608, 0, 4)):
        with pytest.raises(ValueError, match="wgmma"):
            tcore.matmul_tc_plan("k", 1024, 4608, k, bz, 3, ptr, staged=True,
                                 choice=tcore.WGMMA_CHOICE)
    with pytest.raises(ValueError, match="overflow"):
        tcore.matmul_tc_plan("k", 1024, 8, 8 * 16644, 8, 8, 0, staged=True)


@pytest.mark.parametrize("nb,nnz,n", [(576, 3, 40), (40, 3, 24), (33, 5, 17), (7, 1, 9), (64, 8, 8)])
def test_kmajor_values_is_the_values_transposed(nb, nnz, n):
    """The wgmma core's B: (N, K_c) equal to values.reshape(K_c, N).T, rows
    a multiple of 16 bytes apart, the padding zero."""
    gen = torch.Generator().manual_seed(nb * n)
    values = torch.randint(-127, 128, (nb, nnz, n), generator=gen, dtype=torch.int8)
    kt = head_k.kmajor_values(values)
    assert torch.equal(kt, values.reshape(nb * nnz, n).T)
    assert kt.stride(1) == 1 and kt.stride(0) % 16 == 0 and kt.stride(0) - nb * nnz < 16
    padded = torch.as_strided(kt, (n, kt.stride(0)), (kt.stride(0), 1))
    assert not padded[:, nb * nnz:].any()


@pytest.mark.parametrize("nb,nnz", [(576, 3), (40, 3), (33, 5), (2304, 8), (7, 1)])
def test_mux_selectors_hold_each_blocks_positions(nb, nnz):
    """Block b's selector words: nibble i of word j is the position of slot
    4 j + i in its block (0 past nnz), the rows padded to a whole stage of
    32 blocks with zeros."""
    gen = torch.Generator().manual_seed(nb + nnz)
    idx = torch.argsort(torch.rand(nb, 8, generator=gen), dim=1)[:, :nnz].sort(1).values
    sel = head_k.mux_selectors(idx.to(torch.int8), nnz)
    assert sel.dtype == torch.int32 and sel.shape == (-(-nb // 32) * 32, 2)
    nibbles = torch.stack([(sel >> (4 * i)) & 15 for i in range(4)], -1).reshape(-1, 8)
    assert torch.equal(nibbles[:nb, :nnz], idx.to(torch.int32))
    assert not nibbles[:nb, nnz:].any() and not nibbles[nb:].any()


@pytest.mark.parametrize("m", [64, 1024])
def test_stage_vdbb_matmul_holds_the_kmajor_copy_at_prefill_rows(m):
    """An int8 tc product staged at prefill rows takes the wgmma core and
    holds the values K-major with the block selectors; at the head's rows
    it keeps os_mma.cuh and holds no copy. On the CPU both run the plain
    version."""
    rng = np.random.default_rng(m)
    fmt = tv.DBBFormat(8, 3, "matrix")
    w = tv.dbb_encode(torch.from_numpy(rng.normal(size=(256, 40)).astype(np.float32)), fmt,
                      prune=True)
    w = dataclasses.replace(w, values=torch.from_numpy(
        rng.integers(-127, 128, size=tuple(w.values.shape)).astype(np.int8)))
    run, tiles = head_k.stage_vdbb_matmul(w, m)
    idx = w.indices[:, :, 0].contiguous()
    if m == 1024:
        assert tiles == dataclasses.asdict(tcore.WgmmaPlan(128, 128, 4))
        vt, sel = run.kmajor
        assert torch.equal(vt, w.values.reshape(-1, 40).T)
        assert torch.equal(sel, head_k.mux_selectors(idx, 3))
    else:
        assert tiles == dataclasses.asdict(tcore.MmaPlan(64, 8, gathered=True))
        assert run.kmajor is None
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, 256)).astype(np.int8))
    assert torch.equal(run(a), head_k.vdbb_matmul_tc_plain(a, w.values, idx, fmt))


def test_wgmma_choice_off_the_cpu_reaches_the_operand_checks():
    """An int8 tc call choosing the wgmma core, off the CPU, makes its plan
    and reaches the operand checks (which refuse a non-CUDA device)."""
    meta = dict(dtype=torch.int8, device="meta")
    a, values, indices = (torch.empty(1024, 4608, **meta), torch.empty(576, 3, 64, **meta),
                          torch.empty(576, 3, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        head_k.vdbb_matmul_tc(a, values, indices, tv.DBBFormat(8, 3, "matrix"),
                              choice=tcore.WGMMA_CHOICE)


# ----------------------------- host rules of the bf16 tensor-core core

# (K, N, M) of starcoder2-7b's projections at decode (batch 4) and prefill
# (4 x 256 rows), and the bf16 plan: (tile rows, tile columns, split, B chunk)
BF16_LM_PLANS = [((4608, 4608, 4), (16, 128, 4, 16)), ((4608, 4608, 1024), (128, 256, 3, 16)),
                 ((4608, 512, 4), (16, 128, 16, 16)), ((4608, 512, 1024), (128, 256, 8, 16)),
                 ((4608, 18432, 4), (16, 128, 1, 16)), ((4608, 18432, 1024), (128, 256, 1, 16)),
                 ((18432, 4608, 4), (16, 128, 4, 16)), ((18432, 4608, 1024), (128, 256, 8, 16))]


@pytest.mark.parametrize("shape,plan", BF16_LM_PLANS)
def test_bf16_mma_plan_at_the_lm_shapes(shape, plan):
    """Decode takes the 16 x 128 tile and splits K_c over a cluster until
    tiles x split covers the 132 SMs (at most 16 CTAs: wk/wv); prefill takes
    the 128 x 256 tile and, under 4 waves of tiles, the split that balances
    its waves over the SMs (144 tiles, wq/wo and w_down, would leave a
    second wave of 12; w_up's 576 do not split); the values come in 16-byte
    chunks."""
    k, n, m = shape
    got = tcore.bf16_mma_plan("vdbb_matmul_tc", m, n, k // 8 * 3, (0, 256), k=k)
    assert dataclasses.astuple(got) == plan
    if m <= 16:
        tiles = -(-m // got.tile_rows) * -(-n // got.tile_cols)
        assert tiles * got.split >= tcore.BF16_SMS or got.split == 16


@pytest.mark.parametrize("n,v_ptr,chunk", [(129, 256, 2), (1, 256, 2), (40, 256, 16),
                                           (4608, 0x1008, 2), (4608, 0x1002, 2),
                                           (4608, 0x1010, 16)])
def test_bf16_mma_plan_b_chunk_by_n_and_alignment(n, v_ptr, chunk):
    """16-byte chunks need N % 8 == 0 and 16-byte aligned values; any other
    N or address takes the instance that fetches B through registers."""
    assert tcore.bf16_mma_plan("vdbb_matmul_tc", 4, n, 24, (0, v_ptr), k=64).b_chunk == chunk


@pytest.mark.parametrize("m,n,kc,split", [(1, 1, 3, 1), (5, 40, 9, 1), (67, 70, 75, 3),
                                          (67, 70, 600, 7), (130, 129, 24, 1),
                                          (3, 512, 1728, 16)])
def test_bf16_mma_plan_split_never_exceeds_the_stages(m, n, kc, split):
    """The card tests' ragged shapes: a split never exceeds the 32-column
    stages of K_c, so every CTA of a cluster has one at least; one large
    tile of 19 stages splits 7 ways (3 stages a CTA)."""
    assert tcore.bf16_mma_plan("t", m, n, kc, (0, 0), k=8).split == split


@pytest.mark.parametrize("a_ptr,k", [(0x1002, 64), (0x1006, 4608), (0, 63)])
def test_bf16_mma_plan_refuses_what_the_gather_cannot_copy(a_ptr, k):
    """The gather copies the aligned 4-byte word holding each element: an A
    not 4-byte aligned, or an odd K, is refused on the host."""
    with pytest.raises(ValueError, match="4-byte"):
        tcore.bf16_mma_plan("vdbb_matmul_tc", 4, 64, 24, (a_ptr, 0), k=k)


def test_bf16_wrapper_refuses_a_misaligned_gather_before_launch():
    """A bf16 tc product off the CPU with an odd K is refused by the plan
    before any launch (meta tensors: their addresses are 0)."""
    meta = dict(dtype=torch.bfloat16, device="meta")
    a, values = torch.empty(2, 7, **meta), torch.empty(1, 3, 16, **meta)
    indices = torch.empty(1, 3, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="4-byte"):
        head_k.vdbb_matmul_tc(a, values, indices, tv.DBBFormat(7, 3, "matrix"))


@pytest.mark.parametrize("m", [4, 256])
def test_stage_vdbb_matmul_returns_the_bf16_plan(m):
    """A staged bf16 projection carries its tile plan (an A at an
    allocation's start) and, on the CPU, runs the plain version."""
    rng = np.random.default_rng(m)
    fmt = tv.DBBFormat(8, 3, "matrix")
    w = tv.dbb_encode(torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32)), fmt,
                      prune=True)
    w = dataclasses.replace(w, values=w.values.bfloat16())
    run, tiles = head_k.stage_vdbb_matmul(w, m)
    plan = tcore.bf16_mma_plan("vdbb_matmul_tc", m, 40, 24, (0, w.values.data_ptr()), k=64)
    assert tiles == dataclasses.asdict(plan) and tiles["tile_rows"] == (16 if m == 4 else 128)
    a = torch.from_numpy(rng.normal(size=(m, 64)).astype(np.float32)).bfloat16()
    idx = w.indices[:, :, 0].contiguous()
    assert torch.equal(run(a), head_k.vdbb_matmul_tc_plain(a, w.values, idx, fmt))


@pytest.mark.parametrize("switch", ["ONE_NNZ", "NO_MUX", "NO_WGMMA", "NO_CLUSTER"])
def test_wgmma_ablation_switches_find_their_anchor(switch, tmp_path, monkeypatch):
    """Each switch of the wgmma core's ablation applies to os_mma_sm90.cuh as
    it stands: its anchor is there once, and the switched copy lacks it."""
    from repro_torch.kernels import build, mma_ablation

    source, anchor, _ = mma_ablation.SOURCE_SWITCHES[switch]
    assert source == "os_mma_sm90.cuh"
    assert (build.CSRC / source).read_text().count(anchor) == 1
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    out = mma_ablation.variant_sources("probe", ("ONE_NNZ", switch) if switch != "ONE_NNZ"
                                       else (switch,))
    assert anchor not in (out / source).read_text()


@pytest.mark.parametrize("switch", ["NO_B16", "NO_GATHER16", "NO_GATHER_REG", "NO_COMPACT",
                                    "NO_STORE_A", "NO_MMA16", "NO_REDUCE", "NO_PREFILL_SPLIT",
                                    "REG_DECODE", "NARROW"])
def test_bf16_ablation_switches_find_their_anchor(switch, tmp_path, monkeypatch):
    """Each switch of the bf16 core's ablation applies to bf16_mma.cuh as it
    stands: its anchor is there once, and the switched copy lacks it."""
    from repro_torch.kernels import build, mma_ablation

    source, anchor, _ = mma_ablation.SOURCE_SWITCHES[switch]
    assert source == "bf16_mma.cuh"
    assert (build.CSRC / source).read_text().count(anchor) == 1
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    out = mma_ablation.variant_sources("probe", (switch,))
    assert anchor not in (out / source).read_text()


@pytest.mark.parametrize("arch", ["sparse-cnn-s", "sparse-cnn-tiny"])
def test_stem_takes_the_direct_path(arch):
    """The models' fp32 stems (C = 3, 3x3) take the direct conv."""
    from repro_torch.configs import get_cnn_config
    from repro_torch.models.cnn import SparseCNN

    stem = SparseCNN(get_cnn_config(arch)).layers()[0]
    assert stem.in_channels == 3
    assert stem_k.conv_path(torch.float32, 3, stem.kh, stem.kw, stem.stride) == "direct"


@pytest.mark.parametrize("dtype,c,stride,path", [
    (torch.float32, 3, 1, "direct"), (torch.float32, 3, 2, "direct"),
    (torch.float32, 8, 1, "direct"), (torch.float32, 16, 1, "gemm"),
    (torch.float32, 64, 2, "gemm"), (torch.int8, 3, 1, "gemm"), (torch.int8, 64, 1, "gemm")])
def test_stem_path_by_shape(dtype, c, stride, path):
    """fp32 takes the direct conv while a block's halo and weight slice fit
    the budget; int8, and fp32 at a larger C, the implicit GEMM."""
    assert stem_k.conv_path(dtype, c, 3, 3, stride) == path


def test_direct_conv_shared_memory_at_the_stem():
    """A 4 x 32 output tile at stride 1 reads a 6 x 34 pixel halo (612
    floats at C = 3); the weight slice is 27 rows of 96 floats."""
    assert stem_k.direct_smem_bytes(3, 3, 3, 1) == 4 * (612 + 27 * 96)
    assert stem_k.direct_smem_bytes(3, 3, 3, (2, 2)) == 4 * (9 * 65 * 3 + 1 + 27 * 96)
    assert stem_k.direct_smem_bytes(16, 3, 3, 1) > stem_k.DIRECT_SMEM_BYTES


@pytest.mark.parametrize("switch", ["NO_DIV", "NO_FLUSH", "NO_TAPS", "TH8", "FT16", "BLOCKS2",
                                    "NO_ZERO_TEST"])
def test_stem_ablation_switches_find_their_anchor(switch, tmp_path, monkeypatch):
    """Each of the switches of the stem and the flush applies to its source
    as it stands; the flush's two find the division behind the zero test."""
    from repro_torch.kernels import build, mma_ablation

    source, anchor, replacement = mma_ablation.SOURCE_SWITCHES[switch]
    assert (build.CSRC / source).read_text().count(anchor) == 1
    if switch in ("NO_DIV", "NO_ZERO_TEST"):
        assert "__fdiv_rn(y, ep.out_scale[n])" in anchor and "y == 0.0f" in anchor
        assert "y == 0.0f" not in replacement
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    out = mma_ablation.variant_sources("probe", (switch,))
    assert anchor not in (out / source).read_text()


# ------------------------------- host rules of the tc conv's gather (TapMux)


def _sparse_cnn_s_convs():
    """(layer, (H, W, C), kh, kw, stride, padding, nb·nnz) of every
    compressed conv of sparse-cnn-s (the stem is dense)."""
    from repro_torch.configs import get_cnn_config
    from repro_torch.core.sparse_conv import DBBConv2d
    from repro_torch.models.cnn import SparseCNN

    cfg = get_cnn_config("sparse-cnn-s")
    out, h = [], cfg.image_size
    for i, m in enumerate(SparseCNN(cfg).layers()):
        if isinstance(m, DBBConv2d):
            if i > 0:
                kc = m.kh * m.kw * m.in_channels // m.fmt.bz * m.fmt.nnz
                out.append((i, (h, h, m.in_channels), m.kh, m.kw, m.stride, m.padding, kc))
            h = m.out_hw(h, h)[0]
    return out


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("layer", range(1, 8))
def test_mma_tap_plan_at_every_sparse_cnn_s_conv(layer, batch):
    """The tc conv at each compressed layer of sparse-cnn-s and request
    batches 1, 8 and 64: gathered on the core's 8-byte instance, 64 tile
    rows where the batch's pixels are 64 or fewer (l7 at batch 1) and 128
    elsewhere."""
    convs = {c[0]: c[1:] for c in _sparse_cnn_s_convs()}
    assert sorted(convs) == list(range(1, 8))
    (h, w, c), kh, kw, stride, padding, kc = convs[layer]
    (_, _, (ho, wo)) = tcore.conv_geometry(h, w, kh, kw, stride, padding)
    m = batch * ho * wo
    plan = tcore.mma_tap_plan("vdbb_conv_tc", m, kc, kh, kw, w, c)
    assert (plan.tile_rows, plan.chunk, plan.gathered) == (64 if m <= 64 else 128, 8, True)
    assert kc * 127 * 127 < 2**31


@pytest.mark.parametrize("kh,kw,w,c,refused", [
    (3, 3, 64, 64, None), (1, 32, 64, 8, None), (4, 8, 16, 8, None), (5, 7, 16, 8, "taps"),
    (6, 6, 16, 8, "taps"), (1, 33, 64, 8, "taps"),
    # ((kh - 1) * w + kw) * c against 2**27: at the limit, and one channel group past it
    (3, 3, 2**20 - 2, 64, None), (3, 3, 2**20 - 1, 64, "limit"), (1, 1, 1, 2**27 + 8, "limit")])
def test_mma_tap_plan_refuses_what_the_gather_cannot_encode(kh, kw, w, c, refused):
    """A row's tap mask holds 32 taps and a packed source a 27-bit offset."""
    if refused is None:
        assert tcore.mma_tap_plan("k", 100, 72, kh, kw, w, c).gathered
    else:
        with pytest.raises(ValueError, match=refused):
            tcore.mma_tap_plan("vdbb_conv_tc", 100, 72, kh, kw, w, c)


@pytest.mark.parametrize("xshape,kh,kw,nb,nnz,match", [
    # K_c = nb * nnz at MMA_MAX_K = 8 * 16643 (a 1x1 conv over C = 8 * 16643,
    # nnz = bz = 8) and one block past it; 36 taps; a tap offset at 2**27 and past it
    ((1, 1, 1, 8 * 16643), 1, 1, 16643, 8, "CUDA"), ((1, 1, 1, 8 * 16644), 1, 1, 16644, 8, "overflow"),
    ((1, 2, 2, 8), 6, 6, 36, 3, "taps"), ((1, 3, 2**20 - 1, 64), 3, 3, 72, 3, "limit"),
    ((1, 3, 2**20 - 2, 64), 3, 3, 72, 3, "CUDA")])
def test_tc_conv_wrapper_refuses_what_the_gather_cannot_run(xshape, kh, kw, nb, nnz, match):
    """An int8 tc conv off the CPU whose compressed K exceeds MMA_MAX_K, or
    whose taps the gather cannot encode, is refused before any launch; one
    at a limit passes the plan and reaches the operand checks."""
    meta = dict(dtype=torch.int8, device="meta")
    x, values = torch.empty(*xshape, **meta), torch.empty(nb, nnz, 16, **meta)
    indices = torch.empty(nb, nnz, **meta)
    with pytest.raises(ValueError, match=match):
        conv_k.vdbb_im2col_conv_tc(x, values, indices, tv.DBBFormat(8, nnz, "matrix"), kh, kw)
