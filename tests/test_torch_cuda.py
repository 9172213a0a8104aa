"""The port's CUDA kernels on a card, each against its plain PyTorch version
on the same inputs: int8 and int32 results exactly, fp32 within
rtol = atol = 1e-5 (summation order differs), requantized codes from an
fp32 accumulator within one code on at most 0.1 % of entries.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_cnn_config
from repro_torch.core import quant as tq
from repro_torch.core import vdbb as tv
from repro_torch.interop import params_from_numpy, unflatten
from repro_torch.kernels import build
from repro_torch.kernels import im2col_conv as stem_k
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vdbb_im2col_conv as conv_k
from repro_torch.kernels import vdbb_matmul as head_k
from repro_torch.models.cnn import SparseCNN

DATA = Path(__file__).resolve().parent / "data"
TOL = dict(rtol=1e-5, atol=1e-5)


# ResNet's kernel variants, at 0 on the plain layout
_RESNET_VARIANTS = {"vdbb_conv_tc_residual": 0, "im2col_conv_maxpool": 0}


def _per_forward(pattern, n_conv):
    """The exact launches of one forward: the stem, ``n_conv - 1`` compressed
    convs and the head on the pattern's kernels, the other mode's, the LM's
    bf16 tc matmul, the staged int8 one (wgmma) and ResNet's variants at 0."""
    if pattern == "matrix":
        return {"im2col_conv": 1, "vdbb_conv_tc": n_conv - 1, "vdbb_matmul_tc": 1,
                "vdbb_matmul_tc_bf16": 0, "vdbb_matmul_tc_wgmma": 0, "vdbb_conv_bw": 0,
                "vdbb_matmul_bw": 0, **_RESNET_VARIANTS}
    return {"im2col_conv": 1, "vdbb_conv_tc": 0, "vdbb_matmul_tc": 0, "vdbb_matmul_tc_bf16": 0,
            "vdbb_matmul_tc_wgmma": 0, "vdbb_conv_bw": n_conv - 1, "vdbb_matmul_bw": 1,
            **_RESNET_VARIANTS}


pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels are CUDA C++ and run only there")
    with tref.full_fp32():
        yield torch.device("cuda", 0)


def _rng_tensor(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


def _codes_close(got, want):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("dtype", ["int8", "fp32"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_kernel_matches_plain(card, dtype, stride):
    """Ragged everywhere: 9x9 images, F = 72, M not a multiple of the tile."""
    rng = np.random.default_rng(stride)
    x, w, bias = _rng_tensor(rng, 3, 9, 9, 16), _rng_tensor(rng, 3, 3, 16, 72), _rng_tensor(rng, 72)
    dw = tv.dbb_encode_conv(w, tv.DBBFormat(8, 3, "matrix"), prune=True)
    idx = dw.indices[:, :, 0].contiguous().to(card)
    if dtype == "int8":
        qw = tq.quantize_dbb(dw)
        xq = tq.quantize(x, tq.dynamic_act_scale(x))
        args = (xq.to(card), qw.values.to(card), idx, dw.fmt, 3, 3)
        for kw in (dict(scales=(qw.scales * 0.01).to(card), bias=bias.to(card), relu=True,
                        out_scale=0.05, stride=stride),
                   dict(scales=(qw.scales * 0.01).to(card), bias=bias.to(card), stride=stride),
                   dict(stride=stride)):
            assert torch.equal(conv_k.vdbb_im2col_conv_tc(*args, **kw),
                               conv_k.vdbb_im2col_conv_tc_plain(*args, **kw))
    else:
        args = (x.to(card), dw.values.to(card), idx, dw.fmt, 3, 3)
        kw = dict(bias=bias.to(card), relu=True, stride=stride)
        torch.testing.assert_close(conv_k.vdbb_im2col_conv_tc(*args, **kw),
                                   conv_k.vdbb_im2col_conv_tc_plain(*args, **kw), **TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m", [1, 8, 67])
def test_head_kernel_matches_plain(card, m):
    rng = np.random.default_rng(m)
    a, w, bias = _rng_tensor(rng, m, 512), _rng_tensor(rng, 512, 1000), _rng_tensor(rng, 1000)
    qw = tq.quantize_dbb(tv.dbb_encode(w, tv.DBBFormat(8, 3, "matrix"), prune=True))
    aq = tq.quantize(a, tq.dynamic_act_scale(a)).to(card)
    args = (aq, qw.values.to(card), qw.indices[:, :, 0].contiguous().to(card), qw.fmt)
    kw = dict(scales=(qw.scales * 0.01).to(card), bias=bias.to(card))
    assert torch.equal(head_k.vdbb_matmul_tc(*args, **kw), head_k.vdbb_matmul_tc_plain(*args, **kw))
    assert torch.equal(head_k.vdbb_matmul_tc(*args), head_k.vdbb_matmul_tc_plain(*args))
    torch.cuda.synchronize()


def test_stem_kernel_matches_plain(card):
    rng = np.random.default_rng(80)
    x, w, bias = (_rng_tensor(rng, 4, 33, 33, 3).to(card), _rng_tensor(rng, 3, 3, 3, 64, scale=0.2).to(card),
                  _rng_tensor(rng, 64).to(card))
    kw = dict(bias=bias, relu=True, stride=1)
    torch.testing.assert_close(stem_k.im2col_conv(x, w, **kw), stem_k.im2col_conv_plain(x, w, **kw), **TOL)
    _codes_close(stem_k.im2col_conv(x, w, out_scale=0.03, **kw),
                 stem_k.im2col_conv_plain(x, w, out_scale=0.03, **kw))
    xq = torch.randint(-127, 128, (2, 9, 9, 8), dtype=torch.int8, device=card)
    wq = torch.randint(-127, 128, (3, 3, 8, 16), dtype=torch.int8, device=card)
    assert torch.equal(stem_k.im2col_conv(xq, wq, stride=2), stem_k.im2col_conv_plain(xq, wq, stride=2))
    torch.cuda.synchronize()


@pytest.mark.parametrize("group", [None, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_bw_conv_kernel_matches_plain(card, group, stride):
    """Per-column and grouped (indices (nb, nnz, F/4) read in place), ragged:
    9x9 images, F = 72."""
    rng = np.random.default_rng(10 + stride)
    x, w, bias = _rng_tensor(rng, 3, 9, 9, 16), _rng_tensor(rng, 3, 3, 16, 72), _rng_tensor(rng, 72)
    dw = tv.dbb_encode_conv(w, tv.DBBFormat(8, 3, group), prune=True)
    qw = tq.quantize_dbb(dw)
    xq = tq.quantize(x, tq.dynamic_act_scale(x)).to(card)
    args = (xq, qw.values.to(card), qw.indices.to(card), dw.fmt, 3, 3)
    for kw in (dict(scales=(qw.scales * 0.01).to(card), bias=bias.to(card), relu=True,
                    out_scale=0.05, stride=stride),
               dict(stride=stride)):
        assert torch.equal(conv_k.vdbb_im2col_conv_bw(*args, **kw),
                           conv_k.vdbb_im2col_conv_bw_plain(*args, **kw))
    args = (x.to(card), dw.values.to(card), dw.indices.to(card), dw.fmt, 3, 3)
    kw = dict(bias=bias.to(card), relu=True, stride=stride)
    torch.testing.assert_close(conv_k.vdbb_im2col_conv_bw(*args, **kw),
                               conv_k.vdbb_im2col_conv_bw_plain(*args, **kw), **TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("group", [None, 4])
@pytest.mark.parametrize("m", [1, 67])
def test_bw_head_kernel_matches_plain(card, group, m):
    rng = np.random.default_rng(20 + m)
    # weights at the model's 1/sqrt(K) init scale: fp32 outputs of order 1
    a, w = _rng_tensor(rng, m, 512), _rng_tensor(rng, 512, 1000, scale=512 ** -0.5)
    bias = _rng_tensor(rng, 1000)
    dw = tv.dbb_encode(w, tv.DBBFormat(8, 3, group), prune=True)
    qw = tq.quantize_dbb(dw)
    aq = tq.quantize(a, tq.dynamic_act_scale(a)).to(card)
    args = (aq, qw.values.to(card), qw.indices.to(card), qw.fmt)
    kw = dict(scales=(qw.scales * 0.01).to(card), bias=bias.to(card))
    assert torch.equal(head_k.vdbb_matmul_bw(*args, **kw), head_k.vdbb_matmul_bw_plain(*args, **kw))
    assert torch.equal(head_k.vdbb_matmul_bw(*args), head_k.vdbb_matmul_bw_plain(*args))
    a32 = (a.to(card), dw.values.to(card), dw.indices.to(card), dw.fmt)
    torch.testing.assert_close(head_k.vdbb_matmul_bw(*a32, bias=bias.to(card)),
                               head_k.vdbb_matmul_bw_plain(*a32, bias=bias.to(card)), **TOL)
    # the dispatch takes the grouped weight's own indices to the kernel
    build.reset_launches()
    ops.vdbb_matmul(aq, qw.as_dbb().to(card))
    assert build.launch_counts()["vdbb_matmul_bw"] == 1
    torch.cuda.synchronize()


def _golden_on_card(card, pattern, fixture):
    """The JAX reference's fixture through the kernels: later layers exact,
    logits within 1e-3 relative L2."""
    with np.load(fixture) as z:
        tree = unflatten(z)
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                              convs_per_stage=2)
    model = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], card))
    inter = []
    build.reset_launches()
    with torch.no_grad():
        logits = model(torch.from_numpy(tree["input"]).to(card), intermediates=inter)
    n_conv = len(model.layers()) - 1
    assert build.launch_counts() == _per_forward(pattern, n_conv)
    _codes_close(inter[0].cpu(), torch.from_numpy(tree["intermediates"]["0"]))
    convs = model.layers()[:-1]
    with torch.no_grad():
        for i in range(1, n_conv):
            out_scale = convs[i + 1].aq if i + 1 < n_conv else None
            got = convs[i].quant_serve(torch.from_numpy(tree["intermediates"][str(i - 1)]).to(card),
                                       relu=True, out_scale=out_scale)
            assert np.array_equal(got.cpu().numpy(), tree["intermediates"][str(i)])
    want = torch.from_numpy(tree["logits"]).double()
    assert float((logits.cpu().double() - want).norm() / want.norm()) <= 1e-3


def test_golden_fixture_on_card(card):
    _golden_on_card(card, "matrix", DATA / "torch_parity_cnn.npz")


def test_golden_fixture_bw_on_card(card):
    _golden_on_card(card, None, DATA / "torch_parity_cnn_bw.npz")


@pytest.mark.parametrize("pattern", ["matrix", None])
def test_serve_smoke_on_card(card, pattern):
    from repro_torch.launch import serve

    model, _, out = serve.serve("sparse-cnn-tiny", smoke=True, batches=(1, 3), requests=2,
                                device=card, pattern=pattern, log=lambda *_: None)
    n_conv = len(model.layers()) - 1
    for b, r in out.items():
        assert r["logits"].shape == (b, 10) and r["images_per_s"] > 0
        assert r["launches_per_forward"] == _per_forward(pattern, n_conv)


# ------------------------------ the bw kernels' int8 tensor-core instantiation


def _bw_codes(rng, nb, nnz, f, group, *, full=False, bz=8):
    """int8 values (nb, nnz, f) and distinct positions (nb, nnz, f/g) in each
    block column, as the quantizer would leave them: random codes in ±127,
    or every code +127 (``full``, the accumulator's worst case)."""
    g = 1 if group is None else group
    pos = np.argsort(rng.random((nb, bz, f // g)), axis=1)[:, :nnz]
    vals = np.full((nb, nnz, f), 127) if full else rng.integers(-127, 128, (nb, nnz, f))
    return (torch.from_numpy(vals.astype(np.int8)), torch.from_numpy(np.sort(pos, axis=1).astype(np.int8)),
            tv.DBBFormat(bz, nnz, group))


def _act_codes(rng, shape, *, full=False, card, offset=0):
    """int8 activations on the card, ``offset`` bytes past a 16-byte aligned
    allocation (8 moves the kernel to its 8-byte chunks)."""
    n = int(np.prod(shape))
    v = np.full(n, 127) if full else rng.integers(-127, 128, n)
    buf = torch.zeros(n + offset, dtype=torch.int8, device=card)
    buf[offset:] = torch.from_numpy(v.astype(np.int8)).to(card)
    return buf[offset:].view(*shape)


def _int8_exact(kernel, plain, args, f, card, rng, **geom):
    """int8 codes through the full flush, fp32 out of the scale and bias, and
    the raw int32 accumulator: each equal to the plain version."""
    scales = torch.from_numpy(rng.uniform(1e-4, 2e-4, f).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(card)
    for kw in (dict(scales=scales, bias=bias, relu=True, out_scale=0.05),
               dict(scales=scales, bias=bias), {}):
        got, want = kernel(*args, **kw, **geom), plain(*args, **kw, **geom)
        assert got.dtype == want.dtype and torch.equal(got, want), kw
    torch.cuda.synchronize()


# (C, images, H, W, F, nnz, group, stride, byte offset of x)
BW_CONV_MMA_CASES = [
    (8, 3, 9, 9, 72, 3, None, 1, 0), (8, 3, 9, 9, 72, 3, None, 2, 0),
    (24, 3, 9, 9, 72, 3, None, 1, 0), (24, 3, 9, 9, 72, 3, 4, 2, 0),
    (32, 3, 9, 9, 72, 3, None, 2, 0), (64, 3, 9, 9, 72, 3, None, 1, 0),
    (64, 2, 9, 9, 72, 3, 4, 2, 0), (64, 3, 9, 9, 72, 3, None, 1, 8),
    (64, 1, 1, 1, 72, 3, None, 1, 0), (64, 2, 2, 2, 72, 3, None, 1, 0),
    (32, 1, 1, 67, 72, 3, None, 1, 0), (32, 2, 5, 13, 72, 3, None, 1, 0),
    (64, 2, 9, 9, 72, 1, None, 1, 0), (64, 2, 9, 9, 72, 6, None, 1, 0),
    (64, 2, 9, 9, 72, 8, None, 1, 0), (64, 2, 9, 9, 72, 8, 4, 2, 0),
]


@pytest.mark.parametrize("c,n,h,w,f,nnz,group,stride,offset", BW_CONV_MMA_CASES)
def test_bw_conv_int8_tensor_cores_match_plain(card, c, n, h, w, f, nnz, group, stride, offset):
    """8- and 16-byte chunks (C = 8, 24 and an 8-byte offset take 8), both
    tile instances and ragged M (1, 8, 67, 130 pixels), ragged F, nnz 1 to
    8 (both halves of the B stager's fetch), a grouped weight, stride 2 on
    9x9 images (taps outside the image)."""
    rng = np.random.default_rng(c * 1000 + n * 100 + h + nnz)
    values, idx, fmt = _bw_codes(rng, 9 * c // 8, nnz, f, group)
    x = _act_codes(rng, (n, h, w, c), card=card, offset=offset)
    args = (x, values.to(card), idx.to(card), fmt, 3, 3)
    _int8_exact(conv_k.vdbb_im2col_conv_bw, conv_k.vdbb_im2col_conv_bw_plain, args, f, card, rng,
              stride=stride)


# (M, K, N, nnz, group, byte offset of A)
BW_HEAD_MMA_CASES = [
    (1, 512, 1000, 3, None, 0), (8, 512, 1000, 3, None, 0), (67, 512, 1000, 3, 4, 0),
    (130, 512, 1000, 3, None, 0), (130, 24, 72, 3, None, 0), (67, 40, 1000, 1, None, 0),
    (8, 512, 1000, 8, 4, 0), (130, 512, 72, 8, None, 0), (67, 512, 1000, 3, None, 8),
    (67, 512, 1000, 5, 4, 0), (130, 512, 72, 7, None, 0),
]


@pytest.mark.parametrize("m,k,n,nnz,group,offset", BW_HEAD_MMA_CASES)
def test_bw_head_int8_tensor_cores_match_plain(card, m, k, n, nnz, group, offset):
    rng = np.random.default_rng(m * 100 + k + nnz)
    values, idx, fmt = _bw_codes(rng, k // 8, nnz, n, group)
    a = _act_codes(rng, (m, k), card=card, offset=offset)
    _int8_exact(head_k.vdbb_matmul_bw, head_k.vdbb_matmul_bw_plain,
              (a, values.to(card), idx.to(card), fmt), n, card, rng)


@pytest.mark.parametrize("full", [True, False])
def test_bw_int8_full_range_at_k4608(card, full):
    """K = 4608 (sparse-cnn-s's l7) with every code at ±127 range: all +127
    at nnz = 8 reaches |acc| = 4608 * 127 * 127, the accumulator's worst
    case; exact on both kernels."""
    rng = np.random.default_rng(4608 + full)
    values, idx, fmt = _bw_codes(rng, 576, 8, 72, None, full=full)
    x = _act_codes(rng, (2, 5, 5, 512), full=full, card=card)
    args = (x, values.to(card), idx.to(card), fmt, 3, 3)
    _int8_exact(conv_k.vdbb_im2col_conv_bw, conv_k.vdbb_im2col_conv_bw_plain, args, 72, card, rng,
              stride=1)
    a = _act_codes(rng, (67, 4608), full=full, card=card)
    _int8_exact(head_k.vdbb_matmul_bw, head_k.vdbb_matmul_bw_plain,
              (a, values.to(card), idx.to(card), fmt), 72, card, rng)
    if full:
        raw = head_k.vdbb_matmul_bw(a, values.to(card), idx.to(card), fmt)
        assert int(raw.max()) == 4608 * 127 * 127


@pytest.mark.parametrize("bz,nnz,c,group", [(4, 2, 8, None), (4, 3, 24, 4), (16, 5, 16, None),
                                           (16, 16, 32, None)])
def test_bw_int8_other_block_sizes(card, bz, nnz, c, group):
    """A block of 4 (two blocks in 8 rows of K) or 16 (half a block) takes
    the B stager's general path; still exact on both kernels."""
    rng = np.random.default_rng(100 * bz + c)
    values, idx, fmt = _bw_codes(rng, 9 * c // bz, nnz, 72, group, bz=bz)
    x = _act_codes(rng, (2, 9, 9, c), card=card)
    args = (x, values.to(card), idx.to(card), fmt, 3, 3)
    _int8_exact(conv_k.vdbb_im2col_conv_bw, conv_k.vdbb_im2col_conv_bw_plain, args, 72, card, rng,
              stride=2)
    a = _act_codes(rng, (67, 9 * c), card=card)
    _int8_exact(head_k.vdbb_matmul_bw, head_k.vdbb_matmul_bw_plain,
              (a, values.to(card), idx.to(card), fmt), 72, card, rng)


# ------------------------- the tc head's int8 tensor-core instantiation


def _tc_codes(rng, nb, nnz, n, bz=8, *, full=False):
    """int8 values (nb, nnz, n) and one pattern (nb, nnz) of distinct
    positions in each block, shared by every column: random codes in ±127,
    or every code +127 (``full``)."""
    pos = np.sort(np.argsort(rng.random((nb, bz)), axis=1)[:, :nnz], axis=1)
    vals = np.full((nb, nnz, n), 127) if full else rng.integers(-127, 128, (nb, nnz, n))
    return (torch.from_numpy(vals.astype(np.int8)), torch.from_numpy(pos.astype(np.int8)),
            tv.DBBFormat(bz, nnz, "matrix"))


# (M, K, N, nnz, bz, byte offset of A)
TC_HEAD_MMA_CASES = [
    (1, 512, 1000, 3, 8, 0), (8, 512, 1000, 3, 8, 0), (64, 512, 1000, 3, 8, 0),
    (67, 512, 1000, 3, 8, 0), (130, 512, 1000, 3, 8, 0), (64, 80, 1000, 3, 8, 0),
    (130, 80, 72, 1, 8, 0), (1, 80, 72, 2, 8, 1), (64, 512, 72, 4, 8, 0),
    (67, 512, 1000, 5, 8, 3), (8, 80, 1000, 6, 8, 0), (130, 512, 1000, 7, 8, 0),
    (64, 512, 1000, 8, 8, 0), (64, 512, 1000, 3, 16, 0), (67, 80, 72, 5, 16, 0),
    (1, 512, 1000, 8, 16, 0), (130, 80, 1000, 1, 16, 1), (8, 512, 72, 2, 16, 0),
]


@pytest.mark.parametrize("m,k,n,nnz,bz,offset", TC_HEAD_MMA_CASES)
def test_tc_head_int8_tensor_cores_match_plain(card, m, k, n, nnz, bz, offset):
    """The gather stager over the compressed K on both tile instances:
    int8 codes, fp32 dequant + bias and the raw int32 accumulator, each
    equal to the plain version. Ragged M and N, a compressed K that ends
    inside a stage or inside an 8-byte group (K = 80: K_c from 5 to 60),
    blocks of 8 and 16, nnz 1 to 8, and A at odd addresses (the gather needs
    no alignment)."""
    rng = np.random.default_rng(m * 1000 + k + 10 * nnz + bz + offset)
    values, idx, fmt = _tc_codes(rng, k // bz, nnz, n, bz)
    a = _act_codes(rng, (m, k), card=card, offset=offset)
    _int8_exact(head_k.vdbb_matmul_tc, head_k.vdbb_matmul_tc_plain,
                (a, values.to(card), idx.to(card), fmt), n, card, rng)


@pytest.mark.parametrize("full", [True, False])
def test_tc_head_int8_full_range_at_kc4608(card, full):
    """K_c = 4608 (nnz = bz = 8 over K = 4608) with every code at ±127
    range: all +127 drives |acc| to 4608 * 127 * 127, the accumulator's
    worst case; exact."""
    rng = np.random.default_rng(4609 + full)
    values, idx, fmt = _tc_codes(rng, 576, 8, 72, full=full)
    a = _act_codes(rng, (67, 4608), full=full, card=card)
    args = (a, values.to(card), idx.to(card), fmt)
    _int8_exact(head_k.vdbb_matmul_tc, head_k.vdbb_matmul_tc_plain, args, 72, card, rng)
    if full:
        assert int(head_k.vdbb_matmul_tc(*args).max()) == 4608 * 127 * 127


# ----------------- the tc matmul's wgmma core (csrc/os_mma_sm90.cuh)

# (M, K, N): ragged rows, columns off the 128-column tile, a last stage of
# 8 blocks (K = 320) or 2 (K = 2064) of its 32
WGMMA_RAGGED = [(129, 320, 1000), (1000, 320, 4616), (129, 2064, 1000), (1000, 2064, 4616)]


@pytest.mark.parametrize("nnz", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m,k,n", WGMMA_RAGGED)
def test_tc_matmul_wgmma_equals_os_mma_and_plain(card, m, k, n, nnz):
    """The wgmma core equals os_mma.cuh's instance and the plain version
    exactly (torch.equal) through every flush: int8 codes (scale, bias,
    ReLU, out_scale), fp32 (scale, bias), the raw int32 accumulator; called
    with its choice (a K-major copy made for the call) and staged."""
    from repro_torch.kernels import core as tcore

    rng = np.random.default_rng(m * nnz + k + n)
    values, idx, fmt = _tc_codes(rng, k // 8, nnz, n)
    a = _act_codes(rng, (m, k), card=card)
    args = (a, values.to(card), idx.to(card), fmt)
    _int8_exact(lambda *x, **kw: head_k.vdbb_matmul_tc(*x, **kw, choice=tcore.WGMMA_CHOICE),
                head_k.vdbb_matmul_tc_plain, args, n, card, rng)
    _int8_exact(lambda *x, **kw: head_k.vdbb_matmul_tc(*x, **kw, choice=tcore.WGMMA_CHOICE),
                lambda *x, **kw: head_k.vdbb_matmul_tc(*x, **kw, choice={"tile_rows": 128}),
                args, n, card, rng)
    w = tv.DBBWeight(values.to(card), idx[:, :, None].to(card), fmt, (k, n))
    run, tiles = head_k.stage_vdbb_matmul(w, m, choice=tcore.WGMMA_CHOICE)
    assert tiles["core"] == "wgmma"
    assert torch.equal(run(a), head_k.vdbb_matmul_tc_plain(*args))


@pytest.mark.parametrize("k,n", [(4608, 4608), (18432, 4608)], ids=["wq", "w_down"])
def test_tc_matmul_wgmma_at_starcoder2_prefill(card, k, n):
    """starcoder2-7b's wq and w_down at a 1 024-row prefill, staged as the
    INT8 plan stages them: equal to os_mma.cuh's instance and to the plain
    version, raw and through the fp32 dequant flush."""
    rng = np.random.default_rng(k)
    values, idx, fmt = _tc_codes(rng, k // 8, 3, n)
    a = _act_codes(rng, (1024, k), card=card)
    args = (a, values.to(card), idx.to(card), fmt)
    w = tv.DBBWeight(args[1], args[2][:, :, None], fmt, (k, n))
    for kw in (dict(scales=torch.rand(n, device=card) * 1e-4), {}):
        run, tiles = head_k.stage_vdbb_matmul(w, 1024, **kw)
        assert tiles["core"] == "wgmma"
        got = run(a)
        assert torch.equal(got, head_k.vdbb_matmul_tc(*args, **kw, choice={"tile_rows": 128}))
        assert torch.equal(got, head_k.vdbb_matmul_tc_plain(*args, **kw))


@pytest.mark.parametrize("m,counted", [(1024, "vdbb_matmul_tc_wgmma"), (64, "vdbb_matmul_tc")])
def test_wgmma_core_counts_at_prefill_rows_os_mma_at_head_rows(card, m, counted):
    """A product staged at 1 024 rows launches the wgmma core and counts as
    ``vdbb_matmul_tc_wgmma``, not ``vdbb_matmul_tc``; at 64 rows (the head,
    decode) the reverse."""
    rng = np.random.default_rng(m)
    values, idx, fmt = _tc_codes(rng, 64, 3, 256)
    w = tv.DBBWeight(values.to(card), idx[:, :, None].to(card), fmt, (512, 256))
    run, _ = head_k.stage_vdbb_matmul(w, m)
    a = _act_codes(rng, (m, 512), card=card)
    build.reset_launches()
    run(a)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    other = "vdbb_matmul_tc" if counted.endswith("wgmma") else "vdbb_matmul_tc_wgmma"
    assert counts[counted] == 1 and counts[other] == 0


def test_wgmma_kernel_name_matches_the_int8_roofline_metric(card):
    """A profiled launch of the wgmma core carries a name the benchmark's
    ``int8_matmul_roofline`` reads (``portbench/metrics``: every substring
    of a pattern), as os_mma.cuh's GatherMux instance did."""
    import importlib
    import sys

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import core as tcore

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    patterns = importlib.import_module("portbench.metrics.int8_matmul_roofline").PATTERNS
    rng = np.random.default_rng(5)
    values, idx, fmt = _tc_codes(rng, 64, 3, 256)
    a = _act_codes(rng, (256, 512), card=card)
    args = (a, values.to(card), idx.to(card), fmt)
    head_k.vdbb_matmul_tc(*args, choice=tcore.WGMMA_CHOICE)
    torch.cuda.synchronize()
    names = set()
    for _ in range(5):  # a profiled pass may deliver no kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                head_k.vdbb_matmul_tc(*args, choice=tcore.WGMMA_CHOICE)
            torch.cuda.synchronize()
        names = {ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA and "os_mma_sm90" in ev.name}
        if names:
            break
    assert names and all(any(all(p in nm for p in pat) for pat in patterns) for nm in names)


# ------------------------- the tc conv's int8 tensor-core instantiation


# (C, images, H, W, F, kh, kw, nnz, bz, stride, padding, byte offset of x)
TC_CONV_MMA_CASES = [
    (8, 3, 9, 9, 72, 3, 3, 3, 8, 1, "SAME", 0), (8, 2, 9, 9, 72, 3, 3, 1, 8, 2, "SAME", 0),
    (24, 3, 9, 9, 72, 3, 3, 3, 8, 2, "SAME", 1), (64, 3, 9, 9, 72, 3, 3, 3, 8, 1, "VALID", 0),
    (64, 2, 9, 9, 64, 3, 3, 3, 8, 2, ((0, 2), (1, 1)), 3), (512, 2, 5, 5, 72, 3, 3, 3, 8, 1, "SAME", 0),
    (512, 1, 8, 8, 520, 3, 3, 3, 8, 1, "SAME", 0), (64, 2, 9, 9, 72, 1, 1, 3, 8, 1, "SAME", 0),
    (64, 2, 9, 9, 72, 1, 1, 3, 8, 2, "VALID", 0), (16, 2, 11, 11, 72, 5, 5, 3, 8, 1, "SAME", 0),
    (16, 2, 11, 11, 72, 5, 5, 2, 8, 2, "VALID", 0), (8, 2, 9, 9, 72, 3, 3, 2, 4, 1, "SAME", 0),
    (24, 2, 9, 9, 72, 3, 3, 3, 4, 2, ((1, 0), (2, 1)), 0), (32, 2, 9, 9, 72, 3, 3, 5, 16, 2, "SAME", 0),
    (16, 2, 7, 7, 72, 3, 3, 16, 16, 1, "SAME", 0), (64, 2, 9, 9, 72, 3, 3, 1, 8, 1, "SAME", 0),
    (64, 2, 9, 9, 72, 3, 3, 8, 8, 1, "SAME", 0), (64, 1, 1, 1, 72, 3, 3, 3, 8, 1, "SAME", 0),
    (32, 1, 1, 67, 72, 3, 3, 3, 8, 1, "SAME", 0), (32, 2, 5, 13, 72, 3, 3, 3, 8, 1, "SAME", 0),
    (64, 2, 2, 2, 72, 2, 2, 3, 8, 1, "SAME", 0),
]


@pytest.mark.parametrize("c,n,h,w,f,kh,kw,nnz,bz,stride,padding,offset", TC_CONV_MMA_CASES)
def test_tc_conv_int8_tensor_cores_match_plain(card, c, n, h, w, f, kh, kw, nnz, bz, stride,
                                               padding, offset):
    """The tap gather stager over the compressed K on both tile instances:
    int8 codes, fp32 dequant + bias and the raw int32 accumulator, each
    equal to the plain version. C of 8 to 512; a tap of 1 to 192 compressed
    columns, so one 64-column stage spans every tap (C = 8: 9 or 27 columns
    in all), 16 taps of a 5x5 (C = 16, nnz = 2), or ends inside one tap;
    1x1, 2x2, 3x3 and 5x5 taps, strides 1 and 2, SAME, VALID and explicit
    padding; blocks of 4, 8 and 16, nnz 1 to 16; M of 1 to 243 pixels, none
    a multiple of 128, and F of 72 and 520; x at odd addresses (the gather
    needs no alignment)."""
    rng = np.random.default_rng(c * 1000 + n * 100 + h + 10 * kh + nnz + bz + stride + offset)
    values, idx, fmt = _tc_codes(rng, kh * kw * c // bz, nnz, f, bz)
    x = _act_codes(rng, (n, h, w, c), card=card, offset=offset)
    args = (x, values.to(card), idx.to(card), fmt, kh, kw)
    _int8_exact(conv_k.vdbb_im2col_conv_tc, conv_k.vdbb_im2col_conv_tc_plain, args, f, card, rng,
                stride=stride, padding=padding)


@pytest.mark.parametrize("full", [True, False])
def test_tc_conv_int8_full_range_at_kc4608(card, full):
    """K_c = 4608 (C = 512, 3x3, nnz = bz = 8) with every code at +-127
    range: all +127 drives an interior pixel's |acc| to 4608 * 127 * 127,
    the accumulator's worst case; exact."""
    rng = np.random.default_rng(4610 + full)
    values, idx, fmt = _tc_codes(rng, 576, 8, 72, full=full)
    x = _act_codes(rng, (2, 5, 5, 512), full=full, card=card)
    args = (x, values.to(card), idx.to(card), fmt, 3, 3)
    _int8_exact(conv_k.vdbb_im2col_conv_tc, conv_k.vdbb_im2col_conv_tc_plain, args, 72, card, rng)
    if full:
        assert int(conv_k.vdbb_im2col_conv_tc(*args).max()) == 4608 * 127 * 127


def test_tc_conv_int8_runs_the_tap_gather_on_the_tensor_cores(card):
    """The int8 tc conv launches one os_mma kernel with the TapMux stager
    and never the CUDA-core loop (os_gemm)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(15)
    values, idx, fmt = _tc_codes(rng, 72, 3, 64)
    x = _act_codes(rng, (2, 9, 9, 64), card=card)
    args = (x, values.to(card), idx.to(card), fmt, 3, 3)
    conv_k.vdbb_im2col_conv_tc(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        conv_k.vdbb_im2col_conv_tc(*args, out_scale=0.05, relu=True)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert any("os_mma" in name and "TapMux" in name for name in names), names
    assert not any("os_gemm" in name for name in names), names


# ----------------------------------------------- the stem's two paths


# (images, H, W, F, stride)
STEM_DIRECT_CASES = [(4, 33, 33, 64, 1), (4, 33, 33, 64, 2), (3, 33, 33, 72, 1),
                     (3, 33, 33, 72, 2), (2, 33, 33, 16, 1), (2, 33, 33, 16, 2)]


@pytest.mark.parametrize("n,h,w,f,stride", STEM_DIRECT_CASES)
def test_stem_direct_conv_matches_plain(card, n, h, w, f, stride):
    """C = 3 on the direct path: ragged 33 x 33 images (8 x 32 pixel tiles
    cut at the edges), F over one 64-filter tile (72) and under it (16).
    fp32 within rtol = atol = 1e-5, requantized codes within one code on at
    most 0.1 % of entries (summation order)."""
    assert stem_k.conv_path(torch.float32, 3, 3, 3, stride) == "direct"
    rng = np.random.default_rng(100 * n + f + stride)
    x, wt = _rng_tensor(rng, n, h, w, 3).to(card), _rng_tensor(rng, 3, 3, 3, f, scale=0.2).to(card)
    bias = _rng_tensor(rng, f).to(card)
    for kw in (dict(bias=bias, relu=True, stride=stride), dict(stride=stride)):
        torch.testing.assert_close(stem_k.im2col_conv(x, wt, **kw),
                                   stem_k.im2col_conv_plain(x, wt, **kw), **TOL)
        _codes_close(stem_k.im2col_conv(x, wt, out_scale=0.03, **kw),
                     stem_k.im2col_conv_plain(x, wt, out_scale=0.03, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kh,kw,stride,padding", [
    (5, 5, 1, "SAME"), (2, 2, 2, "VALID"), (3, 3, 1, ((0, 2), (1, 1))), (1, 3, 2, "SAME")])
def test_stem_direct_conv_other_geometries(card, kh, kw, stride, padding):
    """The direct path at other kernel sizes and paddings (an even kernel,
    VALID, explicit uneven pads), C = 3, F = 64, ragged 21 x 19 images."""
    assert stem_k.conv_path(torch.float32, 3, kh, kw, stride) == "direct"
    rng = np.random.default_rng(10 * kh + kw + stride)
    x = _rng_tensor(rng, 2, 21, 19, 3).to(card)
    wt = _rng_tensor(rng, kh, kw, 3, 64, scale=0.2).to(card)
    kw_ = dict(bias=_rng_tensor(rng, 64).to(card), relu=True, stride=stride, padding=padding)
    torch.testing.assert_close(stem_k.im2col_conv(x, wt, **kw_), stem_k.im2col_conv_plain(x, wt, **kw_),
                               **TOL)
    _codes_close(stem_k.im2col_conv(x, wt, out_scale=0.03, **kw_),
                 stem_k.im2col_conv_plain(x, wt, out_scale=0.03, **kw_))
    torch.cuda.synchronize()


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_fp32_implicit_gemm_path_matches_plain(card, stride):
    """fp32 at C = 16, too large for the direct path's budget, on the
    implicit GEMM (os_gemm.cuh)."""
    assert stem_k.conv_path(torch.float32, 16, 3, 3, stride) == "gemm"
    rng = np.random.default_rng(160 + stride)
    x, wt = _rng_tensor(rng, 2, 17, 17, 16).to(card), _rng_tensor(rng, 3, 3, 16, 72, scale=0.1).to(card)
    kw = dict(bias=_rng_tensor(rng, 72).to(card), relu=True, stride=stride)
    torch.testing.assert_close(stem_k.im2col_conv(x, wt, **kw), stem_k.im2col_conv_plain(x, wt, **kw),
                               **TOL)
    _codes_close(stem_k.im2col_conv(x, wt, out_scale=0.03, **kw),
                 stem_k.im2col_conv_plain(x, wt, out_scale=0.03, **kw))
    torch.cuda.synchronize()


# ------------------------------------------------- the flush's NaN and ±inf


def _nan_same(got, want, *, exact=True):
    """NaN where the plain version has NaN, and equal elsewhere (within
    rtol = atol = 1e-5 for fp32, one code on at most 0.1 % of entries for
    codes, when not ``exact``: the stem's fp32 summation order)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        assert torch.equal(got.isnan(), want.isnan())
        got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
    if exact:
        assert torch.equal(got, want)
    elif got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, **TOL)
    else:
        _codes_close(got, want)


def _poisoned_rows(rng, f, card, scale=1.0):
    """A scale row and a bias row of ``f`` entries, each with NaN and ±inf
    in some columns."""
    s = (rng.uniform(1.0, 2.0, f) * scale).astype(np.float32)
    b = rng.normal(size=f).astype(np.float32)
    s[[1, 2]] = [np.nan, np.inf]
    b[[3, 4, 5]] = [np.nan, -np.inf, np.inf]
    return torch.from_numpy(s).to(card), torch.from_numpy(b).to(card)


def _flush_cases(scales, bias):
    """NaN in the bias, in the scale and in the requantize scale, with and
    without ReLU, fp32 and int8 outputs."""
    nan_out = torch.full_like(bias, 0.05)
    nan_out[7] = float("nan")
    for relu in (False, True):
        for out_scale in (None, 0.05, nan_out):
            yield dict(scales=scales, bias=bias, relu=relu, out_scale=out_scale)


@pytest.mark.parametrize("mode", ["tc", "bw"])
def test_flush_nan_compressed_kernels_match_plain(card, mode):
    """The four compressed kernels' int8 paths at a layer of sparse-cnn-s's
    shape family: NaN and ±inf in the scale, bias and requantize rows
    flushed as the plain versions flush them (NaN through ReLU, NaN codes
    0), exactly."""
    rng = np.random.default_rng(61 if mode == "tc" else 62)
    f = 72
    if mode == "tc":
        values, idx, fmt = _tc_codes(rng, 72, 3, f)
    else:
        values, idx, fmt = _bw_codes(rng, 72, 3, f, None)
    conv = getattr(conv_k, f"vdbb_im2col_conv_{mode}")
    conv_plain = getattr(conv_k, f"vdbb_im2col_conv_{mode}_plain")
    head = getattr(head_k, f"vdbb_matmul_{mode}")
    head_plain = getattr(head_k, f"vdbb_matmul_{mode}_plain")
    x = _act_codes(rng, (2, 9, 9, 64), card=card)
    a = _act_codes(rng, (67, 576), card=card)
    scales, bias = _poisoned_rows(rng, f, card, scale=1e-4)
    cargs = (x, values.to(card), idx.to(card), fmt, 3, 3)
    hargs = (a, values.to(card), idx.to(card), fmt)
    for kw in _flush_cases(scales, bias):
        _nan_same(conv(*cargs, **kw, stride=2), conv_plain(*cargs, **kw, stride=2))
        _nan_same(head(*hargs, **kw), head_plain(*hargs, **kw))
    torch.cuda.synchronize()


def test_flush_nan_stem_matches_plain(card):
    """The stem's direct conv (fp32) with NaN and ±inf in its flush rows."""
    rng = np.random.default_rng(63)
    x = _rng_tensor(rng, 2, 33, 33, 3).to(card)
    wt = _rng_tensor(rng, 3, 3, 3, 64, scale=0.2).to(card)
    scales, bias = _poisoned_rows(rng, 64, card)
    for kw in _flush_cases(scales, bias):
        _nan_same(stem_k.im2col_conv(x, wt, **kw), stem_k.im2col_conv_plain(x, wt, **kw),
                  exact=False)
    torch.cuda.synchronize()


# --------------------------------------------- plans on CUDA graphs


@pytest.fixture(scope="module", params=["matrix", None], ids=["tc", "bw"])
def planned(request):
    """sparse-cnn-s at full width, calibrated on 64 seeded images, with a
    plan set of buckets 1 … 64 captured at warmup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels are CUDA C++ and run only there")
    from repro_torch.launch import serve

    card = torch.device("cuda", 0)
    with tref.full_fp32():
        model, x = serve.build_model("sparse-cnn-s", calib_batch=64, device=card,
                                     pattern=request.param)
        ps = model.plan_set(max_batch=64)
        ps.warmup()
        yield request.param, model, x, ps


def test_graph_replay_equals_unplanned_forward(planned):
    """Each bucket's replay gives the unplanned forward's logits bit for bit
    (staging moves host work, not arithmetic; no kernel uses atomics), the
    warmup captured each bucket once, and a replay launches what one
    forward launches."""
    pattern, model, x, ps = planned
    assert ps.buckets == (1, 2, 4, 8, 16, 32, 64) and ps.trace_count == 7
    n_conv = len(model.layers()) - 1
    for b in (1, 8, 64):
        xb = x[:b].contiguous()
        plan = ps.plans[b]
        replays = plan.replays
        with torch.no_grad():
            want = model(xb)
        assert torch.equal(plan.serve(xb), want)
        assert plan.replays == replays + 1
        launches = plan.graph_launches[(tuple(xb.shape), xb.dtype)]
        assert launches == _per_forward(pattern, n_conv)
    ragged = x[:5].contiguous()
    per = torch.cat([ps.plans[1].serve(ragged[i: i + 1]) for i in range(5)])
    assert torch.equal(ps.serve(ragged), per)
    assert np.array_equal(ps.serve(ragged.cpu().numpy()), per.cpu().numpy())
    torch.cuda.synchronize()
    assert ps.trace_count == 7


def test_graph_replay_on_a_second_thread(planned):
    """Captured on this thread, replayed on another: the same logits, and
    no host sync inside a serve of tensors on the card (the sync debug
    mode raises on one)."""
    import threading

    _, _, x, ps = planned
    xb = x[:8].contiguous()
    want = ps.serve(xb)
    out = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = threading.Thread(target=lambda: out.append(ps.serve(x[:37])))
        t.start()
        t.join(60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not t.is_alive() and torch.equal(out[0][:8], want)
    t = threading.Thread(target=lambda: out.append(ps.serve(xb.cpu().numpy())))
    t.start()
    t.join(60)
    assert not t.is_alive() and np.array_equal(out[1], want.cpu().numpy())
    assert ps.trace_count == 7


def test_plan_stale_after_requantize_on_card():
    """A re-quantize in place moves the fingerprint (StalePlanError), while
    the old graph still replays the tensors it froze."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels are CUDA C++ and run only there")
    from repro_torch.launch import serve
    from repro_torch.models.plan import StalePlanError

    card = torch.device("cuda", 0)
    model, x = serve.build_model("sparse-cnn-tiny", calib_batch=4, device=card, smoke=True)
    plan = model.plan(batch=4)
    before = plan.serve(x)
    with torch.no_grad():
        assert torch.equal(before, model(x))
        _, stats = model(x * 2.0, collect_act_stats=True)
    model.quantize(stats)
    with pytest.raises(StalePlanError):
        plan.check(model.state())
    with pytest.raises(StalePlanError):
        model(x, plan=plan)
    assert torch.equal(plan.serve(x), before)
    torch.cuda.synchronize()


@pytest.mark.parametrize("calibrated", [False, True])
def test_per_layer_plan_captures_and_matches_forward(card, calibrated):
    """A plan of the per-layer chain (a compressed fp32 model, or a
    quantized one without calibration, whose activation scale is taken per
    batch on the card) captures and replays the unplanned forward's logits
    bit for bit."""
    cfg = smoke_cnn_config("sparse-cnn-tiny")
    model = SparseCNN(cfg).init(torch.Generator().manual_seed(0), card).compress()
    if calibrated:
        model.quantize()
    x = _rng_tensor(np.random.default_rng(64), 3, 16, 16, 3).to(card)
    plan = model.plan(batch=3)
    with torch.no_grad():
        want = model(x)
    assert torch.equal(plan.serve(x), want) and plan.trace_count == 1
    torch.cuda.synchronize()


# ------------------------------------------------------------- the LM path


def _bf16_operands(card, m, k, n, nnz):
    rng = np.random.default_rng(m + k + n)
    fmt = tv.DBBFormat(8, nnz, "matrix")
    dw = tv.dbb_encode(_rng_tensor(rng, k, n, scale=k**-0.5), fmt, prune=True)
    a = _rng_tensor(rng, m, k).to(card).bfloat16()
    vals = dw.values.to(card).bfloat16().contiguous()
    idx = dw.indices[:, :, 0].contiguous().to(card)
    return rng, a, vals, idx, fmt


def _bf16_matches_plain(card, m, k, n, nnz):
    """The bf16 instantiation against its plain version, with and without
    a flush (scale, bias, ReLU; and a requantize to int8 codes)."""
    rng, a, vals, idx, fmt = _bf16_operands(card, m, k, n, nnz)
    before = build.launch_counts()["vdbb_matmul_tc_bf16"]
    order = tref.bf16_reorder_bound(a, vals, idx, 8)
    got = head_k.vdbb_matmul_tc(a, vals, idx, fmt)
    tref.check_bf16(got, head_k.vdbb_matmul_tc_plain(a, vals, idx, fmt), order)
    assert build.launch_counts()["vdbb_matmul_tc_bf16"] == before + 1
    scales, bias = torch.rand(n, device=card) + 0.5, _rng_tensor(rng, n).to(card)
    kw = dict(scales=scales, bias=bias, relu=True)
    # the flush scales the sum's difference and rounds its product and its
    # sum once each in fp32
    acc = tv.gather_compressed(a.float(), idx, 8) @ vals.float().reshape(-1, n)
    flush = order * scales + 2.0**-23 * ((acc * scales).abs() + bias.abs())
    tref.check_bf16(head_k.vdbb_matmul_tc(a, vals, idx, fmt, **kw),
                    head_k.vdbb_matmul_tc_plain(a, vals, idx, fmt, **kw), flush)
    q = head_k.vdbb_matmul_tc(a, vals, idx, fmt, out_scale=0.05)
    qp = head_k.vdbb_matmul_tc_plain(a, vals, idx, fmt, out_scale=0.05)
    _codes_close(q, qp)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,k,n,nnz", [(1, 8, 1, 3), (5, 24, 40, 3), (67, 200, 70, 3),
                                       (130, 64, 129, 1), (64, 96, 64, 8), (3, 4608, 512, 3),
                                       (67, 1600, 70, 3)])
def test_tc_matmul_bf16_matches_plain(card, m, k, n, nnz):
    """The bf16 tensor-core instantiation at ragged M, N and K (N = 1 and
    129 on the instance that fetches B through registers), with and without
    a flush."""
    _bf16_matches_plain(card, m, k, n, nnz)


LM_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)]


@pytest.mark.parametrize("m", [4, 1024])
@pytest.mark.parametrize("k,n", LM_SHAPES)
def test_tc_matmul_bf16_at_lm_shapes(card, m, k, n):
    """The bf16 instantiation at every starcoder2-7b projection shape,
    decode and prefill rows, split or not, with every flush."""
    _bf16_matches_plain(card, m, k, n, 3)


# (M, K, N) of the LM shapes the plan splits over a cluster
BF16_SPLIT_SHAPES = [(4, 4608, 4608), (4, 4608, 512), (4, 18432, 4608), (1024, 4608, 512)]


@pytest.mark.parametrize("m,k,n", BF16_SPLIT_SHAPES)
def test_tc_matmul_bf16_split_is_deterministic(card, m, k, n):
    """The split-K sum is reduced in a fixed order: two calls are equal bit
    for bit, and so is a CUDA-graph replay of the call."""
    from repro_torch.kernels import core as tcore

    _, a, vals, idx, fmt = _bf16_operands(card, m, k, n, 3)
    kc = vals.shape[0] * vals.shape[1]
    assert tcore.bf16_mma_plan("t", m, n, kc, (a.data_ptr(), vals.data_ptr()), k=k).split > 1
    first = head_k.vdbb_matmul_tc(a, vals, idx, fmt)
    assert torch.equal(head_k.vdbb_matmul_tc(a, vals, idx, fmt), first)
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        head_k.vdbb_matmul_tc(a, vals, idx, fmt)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        out = head_k.vdbb_matmul_tc(a, vals, idx, fmt)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


def test_tc_matmul_bf16_runs_the_tensor_core_core(card):
    """A bf16 launch of the tc matmul runs one bf16_mma kernel with the
    WordGather stager, at decode (split over a cluster) and at prefill, and
    never the CUDA-core loop (os_gemm)."""
    from torch.profiler import ProfilerActivity, profile

    for m in (4, 256):
        _, a, vals, idx, fmt = _bf16_operands(card, m, 4608, 512, 3)
        head_k.vdbb_matmul_tc(a, vals, idx, fmt)
        torch.cuda.synchronize()
        names = set()
        for _ in range(5):  # a profiled pass may deliver no kernel records
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    head_k.vdbb_matmul_tc(a, vals, idx, fmt)
                torch.cuda.synchronize()
            names = {ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA}
            if names:
                break
        assert any("bf16_mma" in name and "WordGather" in name for name in names), (m, names)
        assert not any("os_gemm" in name or "os_mma" in name for name in names), names


# the recurrent decoders' projection shapes (recurrentgemma-2b, rwkv6-3b)
RECURRENT_SHAPES = [(2560, 2560), (2560, 256), (2560, 7680), (7680, 2560), (2560, 8960),
                    (8960, 2560)]


@pytest.mark.parametrize("m", [4, 1024])
@pytest.mark.parametrize("k,n", RECURRENT_SHAPES)
def test_tc_matmul_bf16_at_recurrent_shapes(card, m, k, n):
    """The bf16 instantiation at every recurrentgemma-2b and rwkv6-3b
    projection shape, decode and prefill rows, with every flush."""
    _bf16_matches_plain(card, m, k, n, 3)


# deepseek-v3-671b's: MLA's wq_a, wq_b, wkv_a (N = 576, a ragged edge on
# the 128- and 256-wide tiles), wkv_b, wo; the shared expert's up/gate, down
MLA_SHAPES = [(7168, 1536), (1536, 24576), (7168, 576), (512, 32768), (16384, 7168),
              (7168, 2048), (2048, 7168)]


@pytest.mark.parametrize("m", [4, 1024])
@pytest.mark.parametrize("k,n", MLA_SHAPES)
def test_tc_matmul_bf16_at_mla_shapes(card, m, k, n):
    """The bf16 instantiation at every deepseek-v3-671b projection shape,
    decode and prefill rows, with every flush."""
    _bf16_matches_plain(card, m, k, n, 3)


@pytest.mark.parametrize("m", [4, 1024])
@pytest.mark.parametrize("k,n", LM_SHAPES + RECURRENT_SHAPES)
def test_tc_matmul_int8_at_lm_shapes(card, m, k, n):
    """The int8 tensor-core path at every starcoder2-7b, recurrentgemma-2b
    and rwkv6-3b projection shape, decode and prefill rows: int32 and the
    fp32 dequant flush exact."""
    _int8_matches_plain(card, m, k, n)


@pytest.mark.parametrize("m", [4, 1024])
@pytest.mark.parametrize("k,n", MLA_SHAPES)
def test_tc_matmul_int8_at_mla_shapes(card, m, k, n):
    """The int8 path at every deepseek-v3-671b projection shape, as the
    INT8 plan runs them: int32 and the fp32 dequant flush exact."""
    _int8_matches_plain(card, m, k, n)


def _int8_matches_plain(card, m, k, n):
    rng = np.random.default_rng(k + n + m)
    nb = k // 8
    vals = torch.from_numpy(rng.integers(-127, 128, (nb, 3, n), dtype=np.int8)).to(card)
    idx = torch.from_numpy(np.sort(np.stack([rng.choice(8, 3, replace=False) for _ in range(nb)]),
                                   axis=1).astype(np.int8)).to(card)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(card)
    fmt = tv.DBBFormat(8, 3, "matrix")
    for kw in ({}, dict(scales=torch.rand(n, device=card) * 1e-4)):
        assert torch.equal(head_k.vdbb_matmul_tc(a, vals, idx, fmt, **kw),
                           head_k.vdbb_matmul_tc_plain(a, vals, idx, fmt, **kw))


def test_lm_plan_captures_and_replays_without_host_sync(card):
    """The smoke starcoder2 LM, INT8-calibrated, planned at (2, 32): one
    capture, a replay equal to the unplanned forward bit for bit, no host
    sync inside a replay, 6 int8 tc matmul launches a block (wq, wk, wv,
    wo, w_up, w_down) and none of the bf16 kernel in a replay."""
    from repro_torch.launch import serve

    rec = serve.serve_lm_plan("starcoder2-7b", batch=2, prompt_len=32, steps=2, device=card,
                              smoke=True, log=lambda *_: None)
    assert rec["bit_identical"] and rec["captures"] == 1
    plan, tokens = rec["plan"], rec["tokens"]
    launches = next(iter(plan.graph_launches.values()))
    assert launches["vdbb_matmul_tc"] == 6 * rec["model"].cfg.num_layers
    assert launches["vdbb_matmul_tc_bf16"] == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = plan.serve(tokens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, rec["logits"]) and plan.trace_count == 1


def _host_spans(prof) -> list:
    """The host's ``repro_torch.*`` spans of a profile, by start."""
    evs = [(e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CPU
           and e.name().startswith("repro_torch.")]
    return [n[len("repro_torch."):] for _, n in sorted(evs)]


def test_spans_name_generates_phases_and_a_graphed_plan_serve(card):
    """Under a profiler on the card: generate's phases in order, each of
    its two captures holding ``plan.capture``'s span, the tokens those of an
    unprofiled call; a graphed plan serve's copy in, replay and copy out
    once a serve, with no capture once the graph exists, and no copy of a
    span among the card's events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    model = serve.build_lm("starcoder2-7b", device=card, smoke=True)
    prompt = serve.prompt_tokens(model, batch=2, seq=16)
    want = serve.generate(model, prompt, gen_len=4, max_len=20)
    with profile(activities=acts) as prof:
        rec = serve.generate(model, prompt, gen_len=4, max_len=20)
    assert _host_spans(prof) == [
        "generate.capture", "capture", "generate.timing_prefill", "generate.prefill",
        "generate.capture", "capture", "generate.reset", "generate.decode", "generate.release"]
    assert torch.equal(rec["tokens"], want["tokens"])
    plan_rec = serve.serve_lm_plan("starcoder2-7b", batch=2, prompt_len=32, steps=2,
                                   device=card, smoke=True, log=lambda *_: None)
    with profile(activities=acts) as prof:
        for _ in range(2):
            plan_rec["plan"].serve(plan_rec["tokens"])
    assert _host_spans(prof) == ["plan.copy_in", "plan.replay", "plan.copy_out"] * 2
    copies = [e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and e.name().startswith("repro_torch.")]
    assert not copies, copies  # a light record function: no copy on the card


def test_a_graphed_plan_serves_spans_move_no_device_reading(card, monkeypatch):
    """The card's copies of a graphed plan serve's spans are no work: the
    readers of kernels and busy time (``timing.device_ms``,
    ``cost_utils.op_breakdown``, ``chip_smoke.profile_forwards``) read the
    same kernels with the spans as with none, no ``repro_torch.`` name among
    them, and about the same device time."""
    import contextlib
    import importlib.util

    from repro_torch import cost_utils
    from repro_torch.kernels import timing
    from repro_torch.launch import serve
    from repro_torch.models import plan as plan_mod

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = serve.serve_lm_plan("starcoder2-7b", batch=2, prompt_len=32, steps=2, device=card,
                              smoke=True, log=lambda *_: None)
    plan, tokens = rec["plan"], rec["tokens"]

    def readings():
        prof = smoke.profile_forwards(plan.serve, tokens, {}, reps=20)
        return (timing.device_ms(lambda: plan.serve(tokens)),
                set(cost_utils.op_breakdown(plan.serve, tokens, profile=True)["kernels"]),
                prof)

    spanned = readings()
    monkeypatch.setattr(plan_mod, "span", lambda name: contextlib.nullcontext())
    bare = readings()
    assert spanned[1] == bare[1] and spanned[1]
    names = spanned[1] | set(spanned[2]["top_other_ms"])
    assert not any(n.startswith("repro_torch.") for n in names), names
    assert spanned[2]["per_kernel_ms"].keys() == bare[2]["per_kernel_ms"].keys()
    assert spanned[0] == pytest.approx(bare[0], rel=0.2)
    assert spanned[2]["device_ms"] == pytest.approx(bare[2]["device_ms"], rel=0.2)


def test_lm_generate_on_card_runs_the_bf16_kernel(card):
    """Greedy generation of the smoke starcoder2 on the card, through its
    CUDA graphs: every projection through the bf16 tc kernel in every
    forward enqueued, and each kept decode step's logits against a fresh
    forward over the prompt and the tokens fed."""
    from repro_torch.launch import serve

    build.reset_launches()
    rec = serve.serve_lm("starcoder2-7b", batch=2, prompt_len=16, gen=6, device=card,
                         smoke=True, keep=(0, 4), log=lambda *_: None)
    counts = build.launch_counts()
    layers = rec["model"].cfg.num_layers
    # through generate's two graphs: each captured after an eager warm-up,
    # then 5 prefill replays (an untimed one, 3 timed, the one kept) and 5
    # decode replays; 6 projections a layer (wq, wk, wv, wo, w_up, w_down).
    # The counters see the warm-ups and the captures, not the replays.
    assert rec["forwards"] == {"prefill": 7, "decode": 7}
    assert rec["replays"] == {"prefill": 5, "decode": 5}
    assert counts["vdbb_matmul_tc_bf16"] == 6 * 4 * layers and counts["vdbb_matmul_tc"] == 0
    replayed = sum(n * rec["graph_launches"][kind]["vdbb_matmul_tc_bf16"]
                   for kind, n in rec["replays"].items())
    assert counts["vdbb_matmul_tc_bf16"] + replayed == 6 * 14 * layers
    for i, lg in rec["logits"].items():
        seq = torch.cat([rec["prompt"], rec["tokens"][:, : i + 1]], dim=1)
        with torch.no_grad():
            fresh = rec["model"].forward(seq)[:, -1:]
        assert float((lg.double() - fresh.double()).norm() / fresh.double().norm()) <= 2e-2


@pytest.mark.parametrize("arch", ["starcoder2-7b", "moonshot-v1-16b-a3b"])
def test_generate_graph_replays_equal_eager_bit_for_bit(card, arch):
    """Smoke starcoder2 (dense MLP) and moonshot (MoE): generate's replayed
    prefill and decode steps give the eager run's tokens and kept logits bit
    for bit; two captures (the prefill's and the step's) and every later
    prefill and step a replay, none captured again; a replay of the step
    launches one bf16 tc matmul per projection."""
    from repro_torch.launch import serve

    build.reset_launches()
    rec = serve.serve_lm(arch, batch=2, prompt_len=16, gen=6, device=card, smoke=True,
                         keep=(0, 2, 4), log=lambda *_: None)
    model = rec["model"]
    eager = serve.generate(model, {"tokens": rec["prompt"]}, gen_len=6, max_len=22,
                           keep=(0, 2, 4), graph=False)
    assert torch.equal(rec["tokens"], eager["tokens"])
    for i in (0, 2, 4):
        assert torch.equal(rec["logits"][i], eager["logits"][i]), i
    assert rec["captures"] == 2 and eager["captures"] == 0
    # prefills: 3 timed, 1 untimed, the kept one; steps: the 5 of the loop
    assert rec["replays"] == {"prefill": 5, "decode": 5}
    per = 6 if arch == "starcoder2-7b" else 7  # q, k, v, o and the MLP's (shared) projections
    layers = model.cfg.num_layers
    assert rec["graph_launches"]["decode"]["vdbb_matmul_tc_bf16"] == per * layers
    assert rec["graph_launches"]["prefill"]["vdbb_matmul_tc_bf16"] == per * layers


@pytest.mark.parametrize("arch", ["starcoder2-7b", "moonshot-v1-16b-a3b"])
def test_captured_prefill_and_step_equal_eager_without_host_sync(card, arch):
    """A forward and a decode step at a tensor position, each captured
    (``plan.capture``) and replayed with no host sync inside the replay,
    equal to the eager calls bit for bit; the step's cache is written in
    place at the position the tensor holds."""
    from repro_torch.launch import serve
    from repro_torch.models.plan import GraphPool, capture

    model = serve.build_lm(arch, device=card, smoke=True)
    toks = serve.prompt_tokens(model, batch=2, seq=16)["tokens"]
    with torch.no_grad():
        eager = model.forward(toks)
        g, out, _ = capture(lambda: model.forward(toks), GraphPool(), card)
        cache_e, cache_g = model.init_cache(2, 20), model.init_cache(2, 20)
        pos = torch.tensor(7, device=card)
        step_e, _ = model.decode_step(cache_e, toks[:, 7:8], 7)
        gs, step_out, _ = capture(lambda: model.decode_step(cache_g, toks[:, 7:8], pos)[0],
                                  GraphPool(), card)
        for c in (cache_g["groups"]["b0"]["k"], cache_g["groups"]["b0"]["v"]):
            c.zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
        gs.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(step_out, step_e)
    assert torch.equal(cache_g["groups"]["b0"]["k"], cache_e["groups"]["b0"]["k"])
    assert bool(cache_g["groups"]["b0"]["k"][:, :, 7].abs().sum() > 0)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_generate_graph_replays_equal_eager_bit_for_bit(card, arch):
    """The smoke recurrent decoders: generate's replayed prefill and decode
    steps (the state advanced in place by every replay) give the eager
    run's tokens and kept logits bit for bit; a replay launches one bf16
    tc matmul per compressed projection."""
    from repro_torch.launch import serve
    from repro_torch.models.common import dbb_leaves

    rec = serve.serve_lm(arch, batch=2, prompt_len=16, gen=6, device=card, smoke=True,
                         keep=(0, 2, 4), log=lambda *_: None)
    model = rec["model"]
    eager = serve.generate(model, {"tokens": rec["prompt"]}, gen_len=6, max_len=22,
                           keep=(0, 2, 4), graph=False)
    assert torch.equal(rec["tokens"], eager["tokens"])
    for i in (0, 2, 4):
        assert torch.equal(rec["logits"][i], eager["logits"][i]), i
    assert rec["captures"] == 2 and rec["replays"] == {"prefill": 5, "decode": 5}
    per = sum(model.cfg.num_groups if path[0] == "layers" else 1
              for path, _ in dbb_leaves(model.defs()))
    assert rec["graph_launches"]["decode"]["vdbb_matmul_tc_bf16"] == per
    assert rec["graph_launches"]["prefill"]["vdbb_matmul_tc_bf16"] == per


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_plan_dynamic_scales_replay_without_host_sync(card, arch):
    """The smoke recurrent decoder, INT8-calibrated and planned at (2, 32):
    its recurrent projections quantize at a per-call scale written on the
    card, so one capture replays with no host sync, equal to the unplanned
    forward bit for bit, every projection on the int8 tc matmul."""
    from repro_torch.launch import serve

    rec = serve.serve_lm_plan(arch, batch=2, prompt_len=32, steps=2, device=card,
                              smoke=True, log=lambda *_: None)
    assert rec["bit_identical"] and rec["captures"] == 1
    launches = next(iter(rec["plan"].graph_launches.values()))
    assert launches["vdbb_matmul_tc"] > 0 and launches["vdbb_matmul_tc_bf16"] == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rec["plan"].serve(rec["tokens"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, rec["logits"])


def test_mla_generate_graph_replays_equal_eager_bit_for_bit(card):
    """The smoke deepseek-v3-671b (MLA, MoE): generate's replayed prefill
    and absorbed decode steps give the eager run's tokens and kept logits
    bit for bit; a replayed prefill launches the bf16 tc matmul for every
    projection (8 a layer), a replayed step for all but ``wkv_b``, which it
    reads decoded."""
    from repro_torch.launch import serve

    rec = serve.serve_lm("deepseek-v3-671b", batch=2, prompt_len=16, gen=6, device=card,
                         smoke=True, keep=(0, 2, 4), log=lambda *_: None)
    model = rec["model"]
    eager = serve.generate(model, {"tokens": rec["prompt"]}, gen_len=6, max_len=22,
                           keep=(0, 2, 4), graph=False)
    assert torch.equal(rec["tokens"], eager["tokens"])
    for i in (0, 2, 4):
        assert torch.equal(rec["logits"][i], eager["logits"][i]), i
    assert rec["captures"] == 2 and rec["replays"] == {"prefill": 5, "decode": 5}
    layers = model.cfg.num_layers
    assert rec["graph_launches"]["prefill"]["vdbb_matmul_tc_bf16"] == 8 * layers
    assert rec["graph_launches"]["decode"]["vdbb_matmul_tc_bf16"] == 7 * layers


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full-width"])
def test_mla_mixer_replay_equals_eager_without_host_sync(card, full):
    """One ``MLAttention`` (the smoke config's, and deepseek-v3-671b's at
    full width: 128 heads, ranks 1536 and 512) on compressed bf16 weights:
    its absorbed decode at a tensor position, captured and replayed with no
    host sync, equals the eager step bit for bit, cache writes included;
    and in fp32 the decode over 16 positions is within 1e-5 of the
    forward."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.attention import MLAttention
    from repro_torch.models.common import init_params
    from repro_torch.models.plan import GraphPool, capture

    cfg = (get_config if full else smoke_config)("deepseek-v3-671b")
    mla = MLAttention(cfg)
    gen = torch.Generator(device=card).manual_seed(0)
    p = init_params(mla.defs(), gen, torch.bfloat16, card,
                    leaf_fn=lambda path, d, w: tv.dbb_encode(w, d.dbb) if d.dbb else w)
    x = torch.randn(4, 16, cfg.d_model, device=card, generator=gen).bfloat16()
    with torch.no_grad():
        _, prefill = mla(p, x, torch.arange(16, device=card).expand(4, 16))
        absorbed = mla.absorbed(p["wkv_b"], torch.bfloat16)
        caches = []
        for _ in range(2):
            c = mla.init_cache(4, 20, torch.bfloat16, card)
            c["c_kv"][:, :16], c["k_rope"][:, :16] = prefill["c_kv"], prefill["k_rope"]
            caches.append(c)
        step = x[:, 15:16].clone()
        want, _ = mla.decode(p, step, caches[0], torch.tensor(16, device=card), absorbed)
        pos = torch.tensor(16, device=card)
        g, got, _ = capture(lambda: mla.decode(p, step, caches[1], pos, absorbed)[0],
                            GraphPool(), card)
        caches[1]["c_kv"][:, 16:].zero_()
        caches[1]["k_rope"][:, 16:].zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for name in ("c_kv", "k_rope"):
        assert torch.equal(caches[1][name], caches[0][name])
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    p32 = {k: dataclasses.replace(v, values=v.values.float()) if hasattr(v, "fmt") else v.float()
           for k, v in p.items()}
    mla32, x32 = MLAttention(cfg32), x.float()
    with torch.no_grad():
        full_out, _ = mla32(p32, x32, torch.arange(16, device=card).expand(4, 16))
        c = mla32.init_cache(4, 16, torch.float32, card)
        dec = torch.cat([mla32.decode(p32, x32[:, i:i + 1], c, torch.tensor(i, device=card))[0]
                         for i in range(16)], dim=1)
    assert float((dec - full_out).norm() / full_out.norm()) <= 1e-5


def test_mla_plan_replays_without_host_sync(card):
    """The smoke deepseek-v3-671b, INT8-calibrated and planned at (2, 32):
    one capture, every MLA and shared-expert projection staged with its
    calibrated scale on the int8 tc matmul (8 a layer), a replay with no
    host sync equal to the unplanned forward bit for bit."""
    from repro_torch.launch import serve

    rec = serve.serve_lm_plan("deepseek-v3-671b", batch=2, prompt_len=32, steps=2,
                              device=card, smoke=True, log=lambda *_: None)
    assert rec["bit_identical"] and rec["captures"] == 1
    launches = next(iter(rec["plan"].graph_launches.values()))
    assert launches["vdbb_matmul_tc"] == 8 * rec["model"].cfg.num_layers
    assert launches["vdbb_matmul_tc_bf16"] == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rec["plan"].serve(rec["tokens"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, rec["logits"])


def test_moe_combine_is_the_same_bits_every_run(card):
    """The MoE's combine and a whole routed layer at moonshot's decode and
    prefill widths: repeated calls and a graph replay give the same bits (no
    atomics race: one add per expert, distinct rows within each), and the
    combine equals its CPU run."""
    from repro_torch.configs import get_config
    from repro_torch.models.mlp import MoEMLP, combine
    from repro_torch.models.plan import GraphPool, capture

    rng = np.random.default_rng(0)
    e, cap, n, d = 64, 24, 256, 2048
    idx = torch.from_numpy(np.stack([np.stack([rng.choice(n, cap, replace=False)
                                               for _ in range(e)]) for _ in range(4)]))
    out = torch.from_numpy(rng.normal(size=(4, e, cap, d)).astype(np.float32)).bfloat16()
    first = combine(out.to(card), idx.to(card), n)
    for _ in range(3):
        assert torch.equal(combine(out.to(card), idx.to(card), n), first)
    assert torch.equal(first.cpu(), combine(out, idx, n))
    cfg = get_config("moonshot-v1-16b-a3b")
    mlp = MoEMLP(dataclasses.replace(cfg, num_shared_experts=0))
    gen = torch.Generator(device=card).manual_seed(0)
    p = {"router": torch.randn(2048, 64, device=card, generator=gen, dtype=torch.bfloat16) * 0.02}
    for k, shape in (("we_up", (64, 2048, 1408)), ("we_gate", (64, 2048, 1408)),
                     ("we_down", (64, 1408, 2048))):
        p[k] = torch.randn(shape, device=card, generator=gen, dtype=torch.bfloat16) * 0.02
    for s in (1, 64):
        x = torch.randn(4, s, 2048, device=card, generator=gen, dtype=torch.bfloat16)
        with torch.no_grad():
            want = mlp(p, x)
            assert torch.equal(mlp(p, x), want)
            g, got, _ = capture(lambda: mlp(p, x), GraphPool(), card)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), s


# ------------------------------------------------------ the launch choices
#
# Every choice the autotuner can make (``kernels/core.py:launch_choices``) is
# held against the plain version, not only the rules' choices: int8 exactly,
# bf16 within ``ref.check_bf16``, the fp32 stem within rtol = atol = 1e-5.

CHOICE_ROWS = [1, 4, 64, 65, 1024]


def _choices(kind, sig):
    from repro_torch.kernels import core as tcore

    out = tcore.launch_choices(kind, sig)
    assert tcore.default_choice(kind, sig) in out
    return out


@pytest.mark.parametrize("m", CHOICE_ROWS)
@pytest.mark.parametrize("mode", ["tc", "bw"])
def test_int8_matmul_every_tile_choice_matches_plain(card, mode, m):
    """Both tile instances (64 and 128 rows) of the int8 head at
    sparse-cnn-tiny's head shape (K = 64, N = 10) and at K = 512, N = 72,
    and the tc matmul's wgmma core at prefill rows, each flush, against the
    plain version."""
    from repro_torch.kernels import core as tcore

    rng = np.random.default_rng(m)
    for k, n in ((64, 10), (512, 72)):
        if mode == "tc":
            values, idx, fmt = _tc_codes(rng, k // 8, 3, n)
            kernel, plain = head_k.vdbb_matmul_tc, head_k.vdbb_matmul_tc_plain
            kind = tcore.KIND_MATMUL_TC
        else:
            values, idx, fmt = _bw_codes(rng, k // 8, 3, n, None)
            kernel, plain = head_k.vdbb_matmul_bw, head_k.vdbb_matmul_bw_plain
            kind = tcore.KIND_MATMUL_BW
        a = _act_codes(rng, (m, k), card=card)
        choices = _choices(kind, tcore.matmul_sig(m, k, n, 8, 3, "int8"))
        rows = [{"tile_rows": 64}, {"tile_rows": 128}]
        wgmma = mode == "tc" and m >= tcore.WGMMA_MIN_M
        assert choices == (rows + [tcore.WGMMA_CHOICE] if wgmma else rows)
        for t in choices:
            _int8_exact(lambda *a_, **kw: kernel(*a_, **kw, choice=t), plain,
                        (a, values.to(card), idx.to(card), fmt), n, card, rng)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("mode", ["tc", "bw"])
def test_int8_conv_every_tile_choice_matches_plain(card, mode, batch):
    """Both tile instances of the int8 conv at sparse-cnn-tiny's compressed
    conv (16 x 16 x 32 -> 64, 3x3, stride 2) and at a stride-1 layer of the
    same widths, against the plain version."""
    from repro_torch.kernels import core as tcore

    rng = np.random.default_rng(batch)
    for h, c, f, stride in ((16, 32, 64, 2), (8, 64, 64, 1)):
        nb = 9 * c // 8
        if mode == "tc":
            values, idx, fmt = _tc_codes(rng, nb, 3, f)
            kernel, plain = conv_k.vdbb_im2col_conv_tc, conv_k.vdbb_im2col_conv_tc_plain
            kind = tcore.KIND_CONV_TC
        else:
            values, idx, fmt = _bw_codes(rng, nb, 3, f, None)
            kernel, plain = conv_k.vdbb_im2col_conv_bw, conv_k.vdbb_im2col_conv_bw_plain
            kind = tcore.KIND_CONV_BW
        x = _act_codes(rng, (batch, h, h, c), card=card)
        ho = -(-h // stride)
        sig = tcore.conv_sig(batch, ho, ho, c, f, 3, 3, stride, stride, 8, 3, "int8")
        for t in _choices(kind, sig):
            _int8_exact(lambda *a_, **kw: kernel(*a_, **kw, choice=t), plain,
                        (x, values.to(card), idx.to(card), fmt, 3, 3), f, card, rng,
                        stride=stride)


@pytest.mark.parametrize("m", CHOICE_ROWS)
@pytest.mark.parametrize("k,n", [(512, 384), (4608, 512)])
def test_bf16_matmul_every_tile_and_split_matches_plain(card, k, n, m):
    """Every bf16 launch choice, the small and the large tile with each legal
    split (the large tile at decode rows, the small one at prefill), against
    the plain version within one bf16 ulp plus the reordering bound."""
    from repro_torch.kernels import core as tcore

    _, a, vals, idx, fmt = _bf16_operands(card, m, k, n, 3)
    order = tref.bf16_reorder_bound(a, vals, idx, 8)
    want = head_k.vdbb_matmul_tc_plain(a, vals, idx, fmt)
    choices = _choices(tcore.KIND_MATMUL_TC, tcore.matmul_sig(m, k, n, 8, 3, "bfloat16"))
    stages = -(-(k // 8 * 3) // 32)
    assert len(choices) == min(16, stages) + min(8, stages)
    for t in choices:
        tref.check_bf16(head_k.vdbb_matmul_tc(a, vals, idx, fmt, choice=t), want, order,
                        f"bf16 {t}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 4])
def test_stem_every_path_matches_plain(card, batch):
    """Both paths of the dense conv at sparse-cnn-tiny's stem (16 x 16 x 3
    -> 32) and at sparse-cnn-s's width (F = 64): fp32 out within 1e-5, the
    requantized codes within one."""
    from repro_torch.kernels import core as tcore

    rng = np.random.default_rng(90 + batch)
    for f in (32, 64):
        x = _rng_tensor(rng, batch, 16, 16, 3).to(card)
        w, bias = _rng_tensor(rng, 3, 3, 3, f, scale=0.2).to(card), _rng_tensor(rng, f).to(card)
        sig = tcore.conv_sig(batch, 16, 16, 3, f, 3, 3, 1, 1, 0, 0, "float32")
        choices = _choices(tcore.KIND_CONV_DENSE, sig)
        assert choices == [{"path": "direct"}, {"path": "gemm"}]
        for t in choices:
            kw = dict(bias=bias, relu=True, choice=t)
            torch.testing.assert_close(stem_k.im2col_conv(x, w, **kw),
                                       stem_k.im2col_conv_plain(x, w, bias=bias, relu=True),
                                       **TOL)
            _codes_close(stem_k.im2col_conv(x, w, out_scale=0.03, **kw),
                         stem_k.im2col_conv_plain(x, w, bias=bias, relu=True, out_scale=0.03))
    torch.cuda.synchronize()


def test_kernels_refuse_a_choice_they_cannot_run(card):
    """The CUDA side validates what the host passes: tile rows other than 64
    or 128, a bf16 split of 0 or above the tile's cluster or the stages, a
    split on the int8 core, each returns cudaErrorInvalidValue (raised by the
    wrapper); the legal neighbours launch."""
    rng = np.random.default_rng(3)
    values, idx, fmt = _tc_codes(rng, 8, 3, 72)
    a = _act_codes(rng, (4, 64), card=card)
    args = (a, values.to(card), idx.to(card), fmt)
    for bad in ({"tile_rows": 96}, {"tile_rows": 32}):
        with pytest.raises(RuntimeError, match="CUDA error"):
            head_k.vdbb_matmul_tc(*args, choice=bad)
    _, ab, vb, ib, fb = _bf16_operands(card, 4, 512, 384, 3)  # K_c = 192: 6 stages
    for bad in ({"tile": "small", "split": 0}, {"tile": "small", "split": 7},
                {"tile": "large", "split": 9}):
        with pytest.raises(RuntimeError, match="CUDA error"):
            head_k.vdbb_matmul_tc(ab, vb, ib, fb, choice=bad)
    head_k.vdbb_matmul_tc(ab, vb, ib, fb, choice={"tile": "small", "split": 6})
    torch.cuda.synchronize()


def test_the_registry_reaches_an_unplanned_launch(card):
    """A tuned entry changes the instance an unplanned launch runs (the
    profiler's kernel names), and clearing it restores the rule's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import core as tcore

    rng = np.random.default_rng(4)
    values, idx, fmt = _tc_codes(rng, 8, 3, 72)
    a = _act_codes(rng, (4, 64), card=card)
    args = (a, values.to(card), idx.to(card), fmt)
    sig = tcore.matmul_sig(4, 64, 72, 8, 3, "int8")

    def names():
        head_k.vdbb_matmul_tc(*args)
        torch.cuda.synchronize()
        for _ in range(5):  # a profiled pass may deliver no kernel records
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    head_k.vdbb_matmul_tc(*args)
                torch.cuda.synchronize()
            got = {ev.name for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA}
            if got:
                return got
        return set()

    try:
        tcore.set_tuned(tcore.KIND_MATMUL_TC, sig, {"tile_rows": 128})
        assert any("os_mma::kernel<128" in n for n in names())
        tcore.clear_tuned()
        assert any("os_mma::kernel<64" in n for n in names())
    finally:
        tcore.clear_tuned()


def test_cnn_search_plans_equal_off_and_rebuild_from_the_cache(card, tmp_path):
    """sparse-cnn-tiny, both patterns: plan sets searched on the card equal
    the 'off' sets bit for bit at every bucket; every entry's tuned time is
    at most its default's; a 'cache' rebuild with the registry cleared runs
    no search and makes the same choices; a later registry change leaves the
    built sets' choices as they were."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import core as tcore
    from repro_torch.launch import serve

    path = tmp_path / "autotune.json"
    try:
        for pattern in ("matrix", None):
            model, x = serve.build_model("sparse-cnn-tiny", calib_batch=8, device=card,
                                         smoke=True, pattern=pattern)
            off = model.plan_set(max_batch=8, tune="off")
            before = autotune.searches()
            tuned = model.plan_set(max_batch=8, tune="search", cache=path)
            assert autotune.searches() > before
            with torch.no_grad():
                for b in tuned.buckets:
                    assert torch.equal(tuned.plans[b].serve(x[:b]), off.plans[b].serve(x[:b]))
            tcore.clear_tuned()
            before = autotune.searches()
            again = model.plan_set(max_batch=8, tune="cache", cache=path)
            assert autotune.searches() == before and again.tiles == tuned.tiles
            for (kind, sig), t in tcore.tuned_entries().items():
                flipped = [c for c in tcore.launch_choices(kind, sig) if c != t][0]
                tcore.set_tuned(kind, sig, flipped)
            assert again.tiles == tuned.tiles
            with torch.no_grad():
                assert torch.equal(again.plans[8].serve(x), off.plans[8].serve(x))
            tcore.clear_tuned()
        for e in autotune.TuneCache(path).entries.values():
            assert e["measured_us"] <= e["default_us"]
    finally:
        tcore.clear_tuned()


# ---------------------------------------------------------------------------
# ResNet-50 v1.5: the residual flush, the max-pool, the 7 x 7 stem, the plan
# ---------------------------------------------------------------------------

# (images, H, W, C, F) of a block's last 1 x 1 conv: stage 1's and stage 4's
RESNET_C3 = {"stage1": (2, 56, 56, 64, 256), "stage4": (2, 7, 7, 512, 2048)}


@pytest.mark.parametrize("out", ["int8", "fp32"])
@pytest.mark.parametrize("shape", sorted(RESNET_C3))
def test_residual_flush_exact_at_resnet_shapes(card, shape, out):
    """The tc conv's residual instance at ResNet-50's 1 x 1 shapes (a block's
    last conv, int8 codes out; the last block's fp32 flush) and a strided
    3 x 3: bit for bit the plain dequantize, bias, residual add, ReLU and
    requantize, and a launch of the ``residual`` variant."""
    n, h, w, c, f = RESNET_C3[shape]
    rng = np.random.default_rng(len(shape) + c)
    for kh, stride in ((1, 1), (3, 2)):
        ho, wo = -(-h // stride), -(-w // stride)
        pad = ((kh // 2, kh // 2),) * 2
        v, idx, fmt = _tc_codes(rng, kh * kh * c // 8, 3, f)
        x = _act_codes(rng, (n, h, w, c), card=card)
        res = _act_codes(rng, (n, ho, wo, f), card=card)
        kw = dict(scales=torch.from_numpy(rng.uniform(1e-4, 2e-4, f).astype(np.float32)).to(card),
                  bias=_rng_tensor(rng, f, scale=0.1).to(card), relu=True,
                  out_scale=0.05 if out == "int8" else None, stride=stride, padding=pad,
                  residual=(res, torch.tensor(0.02, device=card)))
        build.reset_launches()
        got = conv_k.vdbb_im2col_conv_tc(x, v.to(card), idx.to(card), fmt, kh, kh, **kw)
        torch.cuda.synchronize()
        assert build.launch_counts()["vdbb_conv_tc_residual"] == 1
        cpu = {k: (tuple(t.cpu() for t in val) if k == "residual" else
                   val.cpu() if isinstance(val, torch.Tensor) else val) for k, val in kw.items()}
        want = conv_k.vdbb_im2col_conv_tc_plain(x.cpu(), v, idx, fmt, kh, kh, **cpu)
        assert torch.equal(got.cpu(), want), (shape, kh)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_maxpool_kernel_matches_plain(card, dtype):
    """ResNet's 3 x 3 stride-2 pad-1 pool at the stem's output (112 x 112 x
    64, and a ragged 9 x 7 x 32) against ``F.max_pool2d``, exactly."""
    from repro_torch.kernels import maxpool as pool_k

    rng = np.random.default_rng(7)
    for shape in ((2, 112, 112, 64), (3, 9, 7, 32)):
        x = (_act_codes(rng, shape, card=card) if dtype == torch.int8
             else _rng_tensor(rng, *shape).to(card))
        build.reset_launches()
        got = pool_k.maxpool(x, 3, 2, 1)
        torch.cuda.synchronize()
        assert build.launch_counts()["im2col_conv_maxpool"] == 1
        assert torch.equal(got.cpu(), pool_k.maxpool_plain(x.cpu(), 3, 2, 1))


def test_resnet_stem_takes_the_direct_path(card):
    """The 7 x 7 stride-2 stem at C = 3, pad 3, on 224 x 224 images: the
    direct path (65.6 KB of shared memory), fp32 within TOL and int8 codes
    within one code of the plain version."""
    assert stem_k.conv_path(torch.float32, 3, 7, 7, 2) == "direct"
    rng = np.random.default_rng(77)
    x = _rng_tensor(rng, 2, 224, 224, 3).to(card)
    wt = _rng_tensor(rng, 7, 7, 3, 64, scale=0.1).to(card)
    kw = dict(bias=_rng_tensor(rng, 64).to(card), relu=True, stride=2, padding=((3, 3), (3, 3)))
    want = stem_k.im2col_conv_plain(x, wt, **kw)
    torch.testing.assert_close(stem_k.im2col_conv(x, wt, **kw), want, **TOL)
    _codes_close(stem_k.im2col_conv(x, wt, out_scale=0.03, **kw),
                 stem_k.im2col_conv_plain(x, wt, out_scale=0.03, **kw))


# one replay of ResNet-50 v1.5: the stem and its max-pool, 16 blocks' first
# two convs and 4 projections on the tc conv, 16 last convs on its residual
# instance, the head on the tc matmul (M = batch <= 64: os_mma.cuh)
RESNET50_REPLAY = {"im2col_conv": 1, "im2col_conv_maxpool": 1, "vdbb_conv_tc": 36,
                   "vdbb_conv_tc_residual": 16, "vdbb_matmul_tc": 1, "vdbb_matmul_tc_bf16": 0,
                   "vdbb_matmul_tc_wgmma": 0, "vdbb_conv_bw": 0, "vdbb_matmul_bw": 0}


def test_resnet50_plan_bit_identical_to_unplanned(card):
    """The full-size ``resnet50-v1.5`` (224 x 224, 25.5 M weights), seeded
    and calibrated, served at batch 8 through its plan (one CUDA graph) and
    unplanned: the same logits bit for bit, and one replay launches what
    RESNET50_REPLAY states (53 convs and the head)."""
    from repro_torch.launch import serve

    model, x = serve.build_model("resnet50-v1.5", calib_batch=8, device=card, seed=5)
    ps = model.plan_set(buckets=(8,), tune="off")
    with torch.no_grad():
        got = ps.serve(x)
        want = model(x)
    assert got.shape == (8, 1000) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    launches = next(iter(ps.plans[8].graph_launches.values()))
    assert launches == RESNET50_REPLAY
    assert sum(launches.values()) - launches["im2col_conv_maxpool"] == 54
