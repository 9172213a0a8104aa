"""repro_torch.core.vdbb held against repro.core.vdbb: the same numpy
inputs through both, encodings equal exactly (ties included), products
within fp32 tolerance (rtol = atol = 1e-5: summation order differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vdbb as jv
from repro_torch.core import vdbb as tv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FORMATS = [(8, 3, "matrix"), (8, 2, None), (8, 4, 4), (4, 1, "matrix"), (8, 8, None)]


def _fmts(bz, nnz, group):
    return jv.DBBFormat(bz, nnz, group), tv.DBBFormat(bz, nnz, group)


def _weight(seed, k=64, n=32, zero_blocks=True):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    if zero_blocks:
        w[:8, :] = 0.0      # an all-zero block in every column: the tie trap
        w[8:16, 3] = 1.5    # a block of equal magnitudes in one column
    return w


@pytest.mark.parametrize("bz,nnz,group", FORMATS)
def test_encode_matches_reference_exactly(bz, nnz, group):
    jf, tf = _fmts(bz, nnz, group)
    w = _weight(bz * 10 + nnz)
    jw = jv.dbb_encode(jnp.asarray(w), jf, prune=True)
    tw = tv.dbb_encode(torch.from_numpy(w), tf, prune=True)
    np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jw.indices))
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    assert tw.indices.dtype == torch.int8 and tw.shape == tuple(jw.shape)


@pytest.mark.parametrize("bz,nnz,group", FORMATS)
def test_mask_prune_and_decode_match(bz, nnz, group):
    jf, tf = _fmts(bz, nnz, group)
    w = _weight(7 + nnz)
    np.testing.assert_array_equal(tv.dbb_mask(torch.from_numpy(w), tf).numpy(),
                                  np.asarray(jv.dbb_mask(jnp.asarray(w), jf)))
    pruned = tv.dbb_prune(torch.from_numpy(w), tf)
    np.testing.assert_array_equal(pruned.numpy(), np.asarray(jv.dbb_prune(jnp.asarray(w), jf)))
    assert tv.satisfies_dbb(pruned, tf)
    assert tv.satisfies_dbb(torch.from_numpy(w), tf) == bool(jv.satisfies_dbb(jnp.asarray(w), jf))
    tw = tv.dbb_encode(pruned, tf)
    np.testing.assert_array_equal(tv.dbb_decode(tw).numpy(), pruned.numpy())
    np.testing.assert_array_equal(tv.dbb_decode(tw).numpy(),
                                  np.asarray(jv.dbb_decode(jv.dbb_encode(jnp.asarray(w), jf, prune=True))))


def test_all_zero_block_takes_lowest_positions():
    """jax.lax.top_k keeps the lowest index on ties; torch.topk does not."""
    fmt = tv.DBBFormat(8, 3, "matrix")
    tw = tv.dbb_encode(torch.zeros(8, 4), fmt)
    jw = jv.dbb_encode(jnp.zeros((8, 4)), jv.DBBFormat(8, 3, "matrix"))
    assert tw.indices[0, :, 0].tolist() == [0, 1, 2] == np.asarray(jw.indices)[0, :, 0].tolist()


def test_decode_keeps_int8():
    fmt = tv.DBBFormat(8, 3, "matrix")
    tw = tv.dbb_encode(torch.from_numpy(_weight(3)), fmt, prune=True)
    q = tv.DBBWeight(torch.arange(tw.values.numel()).reshape(tw.values.shape).to(torch.int8),
                     tw.indices, fmt, tw.shape)
    assert tv.dbb_decode(q).dtype == torch.int8


@pytest.mark.parametrize("c", [8, 16])
def test_conv_encode_decode_match(c):
    rng = np.random.default_rng(c)
    w = rng.normal(size=(3, 3, c, 12)).astype(np.float32)
    jf, tf = _fmts(8, 3, "matrix")
    jw = jv.dbb_encode_conv(jnp.asarray(w), jf, prune=True)
    tw = tv.dbb_encode_conv(torch.from_numpy(w), tf, prune=True)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    np.testing.assert_array_equal(tv.dbb_decode_conv(tw, 3, 3).numpy(),
                                  np.asarray(jv.dbb_decode_conv(jw, 3, 3)))


@pytest.mark.parametrize("gather", [False, True])
def test_matmul_refs_match(gather):
    rng = np.random.default_rng(11)
    a = rng.normal(size=(10, 64)).astype(np.float32)
    w = _weight(12, zero_blocks=False)
    jf, tf = _fmts(8, 3, "matrix")
    jw = jv.dbb_encode(jnp.asarray(w), jf, prune=True)
    tw = tv.dbb_encode(torch.from_numpy(w), tf, prune=True)
    jfn, tfn = ((jv.dbb_matmul_gather_ref, tv.dbb_matmul_gather_ref) if gather
                else (jv.dbb_matmul_ref, tv.dbb_matmul_ref))
    np.testing.assert_allclose(tfn(torch.from_numpy(a), tw).numpy(),
                               np.asarray(jfn(jnp.asarray(a), jw)), rtol=1e-5, atol=1e-5)


def test_gather_ref_rejects_per_column():
    tw = tv.dbb_encode(torch.from_numpy(_weight(1)), tv.DBBFormat(8, 2, None), prune=True)
    with pytest.raises(ValueError):
        tv.dbb_matmul_gather_ref(torch.zeros(2, 64), tw)


def test_format_checks_match():
    with pytest.raises(ValueError):
        tv.DBBFormat(8, 9)
    with pytest.raises(ValueError):
        tv.dbb_encode(torch.zeros(12, 4), tv.DBBFormat(8, 3))
    f = tv.DBBFormat(8, 3, 4)
    assert (f.group_size(16), f.density, f.is_dense) == (4, 3 / 8, False)
    assert tv.DENSE.is_dense and tv.DBBFormat(8, 3, "matrix").group_size(10) == 10
