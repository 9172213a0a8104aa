"""repro_torch.core.act_sparsity's measures and activation gate held against
repro.core.act_sparsity on the CPU: the same numpy activations through both.

Tolerances, each with the value this file measured beside it:
  - zero and near-zero fractions, per-block counts, the occupancy
    histogram, the activation masks, pruned activations, the encoded
    values and positions, ``act_fmt``: equal (fp32 and bf16, ties included:
    0 differences);
  - ``ops.sparse_matmul(act_fmt=)``'s plain version against the reference's
    in interpret mode: rtol = atol = 1e-5 (fp32 summation order; measured
    max abs difference below 1e-6), and equal to the port's own
    ``vdbb_matmul`` of the pruned activations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from repro.core import act_sparsity as ja
from repro.core import vdbb as jv
from repro.kernels import ops as jops
from repro_torch.core import act_sparsity as ta
from repro_torch.core import vdbb as tv
from repro_torch.kernels import ops as tops

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FORMATS = [(8, 3), (8, 1), (8, 4), (4, 2), (8, 8)]


def _act(seed, shape, *, ties=True):
    """A ReLU'd activation (about half zeros) with an all-zero K-block, a
    block of equal magnitudes and a repeated row: the tie traps."""
    x = np.maximum(np.random.default_rng(seed).normal(size=shape), 0.0).astype(np.float32)
    if ties:
        x2 = x.reshape(-1, shape[-1])
        x2[:, :8] = 0.0
        x2[:, 8:16] = 0.75
        x2[1] = x2[0]
    return x


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jnp.ndarray) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 32)])
def test_measures_match_reference(dtype, shape):
    j, t = _both(_act(1, shape), dtype)
    assert float(ta.zero_fraction(t)) == float(ja.zero_fraction(j))
    assert float(ta.near_zero_fraction(t, 0.3)) == float(ja.near_zero_fraction(j, 0.3))
    for bz in (4, 8):
        got, want = ta.block_nnz_counts(t, bz), ja.block_nnz_counts(j, bz)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        hist = ta.block_nnz_histogram(t, bz)
        assert hist.dtype == torch.int32 and hist.shape == (bz + 1,)
        np.testing.assert_array_equal(hist.numpy(), np.asarray(ja.block_nnz_histogram(j, bz)))


def test_unblockable_feature_dim_raises_in_both():
    x = np.ones((4, 12), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        ja.block_nnz_counts(jnp.asarray(x), 8)
    with pytest.raises(ValueError, match="not divisible"):
        ta.block_nnz_counts(torch.from_numpy(x), 8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bz,nnz", FORMATS)
@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 64)])
def test_mask_and_prune_match_reference_bit_for_bit(dtype, bz, nnz, shape):
    j, t = _both(_act(bz * 10 + nnz, shape), dtype)
    jf, tf = jv.DBBFormat(bz, nnz), tv.DBBFormat(bz, nnz)
    mask = ta.act_dbb_mask(t, tf)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ja.act_dbb_mask(j, jf)))
    pruned = ta.act_dbb_prune(t, tf)
    assert pruned.dtype == t.dtype
    np.testing.assert_array_equal(_np(pruned), _np(ja.act_dbb_prune(j, jf)))
    # the pattern is shared across the tile: one set of K positions survives
    k = shape[-1]
    assert bool((mask.reshape(-1, k) == mask.reshape(-1, k)[:1]).all())
    counts = mask.reshape(-1, k // bz, bz).sum(-1)
    assert int(counts.max()) <= nnz


def test_dense_format_passes_activations_through():
    t = torch.from_numpy(_act(3, (8, 16)))
    assert ta.act_dbb_prune(t, tv.DBBFormat(8, 8)) is t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bz,nnz", FORMATS)
def test_encode_matches_and_decodes_to_the_pruned_tile(dtype, bz, nnz):
    j, t = _both(_act(7 + nnz, (16, 64)), dtype)
    jf, tf = jv.DBBFormat(bz, nnz), tv.DBBFormat(bz, nnz)
    got, want = ta.act_dbb_encode(t, tf), ja.act_dbb_encode(j, jf)
    assert got.fmt.group == "matrix" and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(_np(got.values), _np(want.values))
    back = ta.act_dbb_decode(got)
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(_np(back), _np(ta.act_dbb_prune(t, tf)))
    with pytest.raises(ValueError, match="must be"):
        ta.act_dbb_encode(t.reshape(2, 8, 64), tf)


@pytest.mark.parametrize("zero_frac", [0.0, 0.1, 0.125, 0.3, 0.5, 0.6, 0.625, 0.75, 0.875,
                                       0.9, 0.99, 1.0])
@pytest.mark.parametrize("bz", [None, 4, 8])
def test_act_fmt_matches_reference(zero_frac, bz):
    got = ta.act_fmt(ta.ActStats(zero_frac=zero_frac), bz=bz)
    want = ja.act_fmt(ja.ActStats(zero_frac=zero_frac), bz=bz)
    assert (got.bz, got.nnz, got.group) == (want.bz, want.nnz, want.group)


def test_act_fmt_of_a_measured_activation():
    x = _act(11, (32, 64), ties=False)
    st_t = ta.measure_activation(torch.from_numpy(x))
    st_j = ja.measure_activation(jnp.asarray(x))
    assert st_t.zero_frac == st_j.zero_frac
    assert ta.act_fmt(st_t).nnz == ja.act_fmt(st_j).nnz
    assert repr(st_t).startswith("ActStats(? (32, 64) zero=")


@pytest.mark.parametrize("afmt", [(8, 4), (8, 2), (8, 8), None])
def test_sparse_matmul_plain_version_matches_reference(afmt):
    """The port's ``ops.sparse_matmul(act_fmt=)`` on the CPU (the tc
    kernel's plain version on the pruned activations) against the
    reference's ``ops.sparse_matmul`` in interpret mode."""
    a = _act(4, (16, 64), ties=False)
    w = np.random.default_rng(5).normal(size=(64, 32)).astype(np.float32)
    jf, tf = jv.DBBFormat(8, 3, "matrix"), tv.DBBFormat(8, 3, "matrix")
    jw, tw = jv.dbb_encode(jnp.asarray(w), jf, prune=True), tv.dbb_encode(
        torch.from_numpy(w), tf, prune=True)
    ja_f = None if afmt is None else jv.DBBFormat(*afmt)
    ta_f = None if afmt is None else tv.DBBFormat(*afmt)
    want = jops.sparse_matmul(jnp.asarray(a), jw, act_fmt=ja_f, bm=16, bn=32, kb=8,
                              interpret=True)
    got = tops.sparse_matmul(torch.from_numpy(a), tw, act_fmt=ta_f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pruned = torch.from_numpy(a) if ta_f is None else ta.act_dbb_prune(torch.from_numpy(a), ta_f)
    assert torch.equal(got, tops.vdbb_matmul(pruned, tw))
