"""The port's cost accounting and roofline calibration against the JAX
package's, on the CPU: ``core/vdbb.py``'s ``dbb_gemm_costs`` and
``dbb_conv_costs`` key for key and digit for digit over a grid of formats,
widths, activation sparsities and conv geometries; ``calibrate.py``'s
``fit_calibration`` on the same synthetic probes (the reference's math
exactly; where a term keeps its default, each package's own default, the
port's an H100's, the reference's a TPU's), its cache entries and the
order active → cache → default. Pure functions: no kernel runs.
"""
import math

import numpy as np
import pytest

from repro.core import act_sparsity as jact
from repro.core import vdbb as jv
from repro.kernels import calibrate as jcal
from repro_torch.core import act_sparsity as tact
from repro_torch.core import vdbb as tv
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import calibrate as tcal
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _fmts(bz=8):
    for nnz in range(1, bz + 1):
        for group in ("matrix", None, 4):
            yield (bz, nnz, group)


def _stats(mod, zero_frac):
    return mod.ActStats(name="l", shape=(4, 64), numel=256, zero_frac=zero_frac,
                        near_zero_frac=zero_frac, threshold=0.0, bz=8, macs=1024)


ACTS = [("none", None), ("float", 0.37), ("stats", 0.61)]


def _act(kind, val, mod):
    return _stats(mod, val) if kind == "stats" else val


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("bz,nnz,group", list(_fmts()))
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_dbb_gemm_costs_equal_the_reference(bz, nnz, group, bits):
    for (m, k, n) in ((1, 64, 10), (64, 512, 1000), (1024, 4608, 512)):
        for act_kind, act_val in ACTS:
            for act_bits in (None, 8, 16):
                for fused in (False, True):
                    kw = dict(act_bits=act_bits, epilogue_fused=fused)
                    got = tv.dbb_gemm_costs(m, k, n, tv.DBBFormat(bz, nnz, group), bits,
                                            act=_act(act_kind, act_val, tact), **kw)
                    want = jv.dbb_gemm_costs(m, k, n, jv.DBBFormat(bz, nnz, group), bits,
                                             act=_act(act_kind, act_val, jact), **kw)
                    _same(got, want)


def test_dbb_gemm_costs_dense_remainder_and_refusal():
    """A dense format with a K that is no multiple of bz (the C = 3 stem's
    27) runs its remainder uncompressed on both sides; a sparse one raises
    on both."""
    _same(tv.dbb_gemm_costs(64, 27, 64, tv.DBBFormat()),
          jv.dbb_gemm_costs(64, 27, 64, jv.DBBFormat()))
    for mod in (tv, jv):
        with pytest.raises(ValueError, match="divisible"):
            mod.dbb_gemm_costs(64, 27, 64, mod.DBBFormat(8, 3))


@pytest.mark.parametrize("stride", [1, 2, (1, 2)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("im2col_unit", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_dbb_conv_costs_equal_the_reference(stride, padding, im2col_unit, fused):
    for (n, h, w, c, f, kh, kw) in ((4, 16, 16, 32, 64, 3, 3), (1, 9, 13, 8, 72, 3, 1),
                                    (2, 64, 64, 3, 64, 3, 3)):
        for bz, nnz, group in ((8, 3, "matrix"), (8, 1, None), (8, 8, None), (8, 5, 4)):
            if c % bz and nnz != bz:
                continue
            for act_kind, act_val in ACTS:
                for bits, act_bits in ((8, None), (16, 16), (8, 16)):
                    opts = dict(stride=stride, padding=padding, bits=bits, act_bits=act_bits,
                                im2col_unit=im2col_unit, epilogue_fused=fused)
                    got = tv.dbb_conv_costs(n, h, w, c, f, kh, kw, tv.DBBFormat(bz, nnz, group),
                                            act=_act(act_kind, act_val, tact), **opts)
                    want = jv.dbb_conv_costs(n, h, w, c, f, kh, kw, jv.DBBFormat(bz, nnz, group),
                                             act=_act(act_kind, act_val, jact), **opts)
                    _same(got, want)


def test_act_sparsity_frac_equals_the_reference():
    for val in (None, 0.0, 0.25, 1):
        assert tv._act_sparsity_frac(val) == jv._act_sparsity_frac(val)
    assert tv._act_sparsity_frac(_stats(tact, 0.3)) == jv._act_sparsity_frac(_stats(jact, 0.3))


# ------------------------------------------------------------ the fit


def _probes(rng, n, *, peak=2e14, bw=2e12, ovh=3e-7, noise=0.0, steps=True):
    out = []
    for _ in range(n):
        macs, bytes_ = float(rng.uniform(1e6, 1e11)), float(rng.uniform(1e5, 1e9))
        st = float(rng.integers(10, 300)) if steps else 0.0
        t = macs / peak + bytes_ / bw + st * ovh
        out.append({"macs": macs, "bytes": bytes_, "steps": st,
                    "t_s": t * (1 + noise * float(rng.normal()))})
    return out


def _fit_equal(probes):
    """Both fits on the same probes: a fitted constant equal digit for
    digit, a defaulted one each package's own default."""
    got, want = tcal.fit_calibration(probes, "cpu"), jcal.fit_calibration(probes, "cpu")
    jd, td = jcal.default_calibration("cpu"), tcal.default_calibration("cpu")
    for f in ("peak_macs", "hbm_bw", "step_overhead_s"):
        if getattr(want, f) == getattr(jd, f):
            assert getattr(got, f) == getattr(td, f), f
        else:
            assert getattr(got, f) == getattr(want, f), f
    assert got.residual == want.residual and got.source == want.source
    assert got.backend == "cpu"
    return got


@pytest.mark.parametrize("noise", [0.0, 0.02, 0.2])
@pytest.mark.parametrize("n", [3, 9, 30])
def test_fit_calibration_equals_the_reference(n, noise):
    cal = _fit_equal(_probes(np.random.default_rng(n), n, noise=noise))
    assert all(math.isfinite(v) and v > 0 for v in (cal.peak_macs, cal.hbm_bw,
                                                     cal.step_overhead_s))
    if noise == 0.0:
        assert cal.peak_macs == pytest.approx(2e14, rel=1e-6)
        assert cal.hbm_bw == pytest.approx(2e12, rel=1e-6)
        assert cal.step_overhead_s == pytest.approx(3e-7, rel=1e-6)
        assert cal.residual < 1e-9


def test_fit_calibration_unidentifiable_too_few_and_nonfinite():
    rng = np.random.default_rng(7)
    # no steps column: that term keeps its default on both sides
    cal = _fit_equal(_probes(rng, 8, steps=False))
    assert cal.step_overhead_s == tcal.DEFAULT_STEP_OVERHEAD_S and cal.source == "fit"
    # too few probes, and non-finite ones: the defaults
    for probes in (_probes(rng, 2), [dict(p, t_s=float("nan")) for p in _probes(rng, 5)],
                   [dict(p, macs=float("inf")) for p in _probes(rng, 5)]):
        cal = _fit_equal(probes)
        assert cal.source == "default"
    # times that fall with the MACs drive a coefficient negative: the
    # active-set pass drops it and refits the rest
    probes = _probes(rng, 10)
    for p in probes:
        p["t_s"] = max(1e-6, 1e-3 - p["macs"] / 1e14)
    _fit_equal(probes)


def test_default_calibration_is_the_h100s():
    d = tcal.default_calibration("cuda")
    assert (d.peak_macs, d.hbm_bw) == (989e12 / 2, 3.35e12)
    assert d.backend == "cuda" and d.source == "default" and d.step_overhead_s > 0


def test_probes_spread_the_three_terms():
    """The probes are bf16 launch choices the kernel can run, and each term
    spans an order of magnitude over them."""
    from repro_torch.kernels import core

    terms = []
    for m, k, n, tiles in tcal.PROBES:
        sig = core.matmul_sig(m, k, n, 8, 3, "bfloat16")
        core.check_choice(core.KIND_MATMUL_TC, sig, tiles)
        terms.append(tat.matmul_cost_terms(m, k, n, tcal._PROBE_FMT, tiles, 2.0))
    for col in zip(*terms):
        assert max(col) >= 10 * min(col)


# ---------------------------------------------------- entries and order


def test_entries_round_trip_and_refuse_what_is_not_a_measurement():
    cal = tcal.Calibration("cuda", 1.5e14, 2.5e12, 4e-7, residual=0.12, source="fit")
    back = tcal.from_entry(tcal.to_entry(cal))
    assert back == tcal.Calibration("cuda", 1.5e14, 2.5e12, 4e-7, residual=0.12,
                                    source="cache")
    assert tcal.to_entry(cal).keys() == jcal.to_entry(
        jcal.Calibration("cpu", 1.0, 1.0, 1.0)).keys()
    good = tcal.to_entry(cal)
    for bad in (None, [], dict(good, version=2), {k: v for k, v in good.items() if k != "hbm_bw"},
                dict(good, peak_macs=float("nan")), dict(good, hbm_bw=0.0),
                dict(good, step_overhead_s=-1e-7), dict(good, peak_macs="fast")):
        assert tcal.from_entry(bad) is None
        assert jcal.from_entry(bad) is None


def test_get_calibration_active_then_cache_then_default(tmp_path):
    path = tmp_path / "autotune.json"
    cache = tat.TuneCache(path)
    cached = tcal.Calibration("cuda", 1e14, 1e12, 1e-6)
    cache.calibration["cuda"] = tcal.to_entry(cached)
    cache.save()
    try:
        tcal.clear_active()
        assert tcal.get_calibration("cuda") == tcal.default_calibration("cuda")
        got = tcal.get_calibration("cuda", cache=path)
        assert (got.peak_macs, got.source) == (1e14, "cache")
        assert tcal.get_calibration("cuda", cache=tat.TuneCache(path)) == got
        active = tcal.Calibration("cuda", 3e14, 3e12, 3e-7, source="fit")
        tcal.set_active(active)
        assert tcal.get_calibration("cuda", cache=path) is active
        assert tcal.get_calibration("cpu", cache=path) == tcal.default_calibration("cpu")
    finally:
        tcal.clear_active()


def test_calibrate_measures_nothing_on_the_cpu(tmp_path):
    path = tmp_path / "autotune.json"
    cal = tcal.calibrate(path, force=True, device="cpu")
    assert cal == tcal.default_calibration("cpu") and not path.exists()
