"""The port's launch-choice autotuner (``repro_torch/kernels/autotune.py``),
its registry (``kernels/core.py``) and their plumbing through the plans and
the serving CLI, on the CPU, held against the JAX package where the two
share a contract: cache keys and signatures, the cache file (one file
shared by both packages, each keeping the other's entries), the search's
always-measured default, and the plans' tune modes against the reference's
``tune='off'`` plan on the golden fixtures.

On the CPU nothing is measured (the plain versions take no launch
choices): searches here run on fake builds and timers, and plan builds
with ``'cache'`` and ``'search'`` equal ``'off'`` bit for bit.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.kernels import autotune as jat
from repro.kernels import core as jcore
from repro.models.cnn import SparseCNN as JSparseCNN
from repro_torch.configs import get_cnn_config, smoke_cnn_config
from repro_torch.core.vdbb import DBBFormat
from repro_torch.interop import params_from_numpy, unflatten
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import core as tcore
from repro_torch.kernels import im2col_conv as stem_k
from repro_torch.launch import serve
from repro_torch.models.cnn import SparseCNN

FMT = DBBFormat(8, 3, "matrix")


@pytest.fixture(autouse=True)
def _clean_registry():
    tcore.clear_tuned()
    yield
    tcore.clear_tuned()


# ---------------------------------------------------------------- keys


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32), (torch.int8, jnp.int8),
                                     (torch.bfloat16, jnp.bfloat16)])
def test_signatures_and_keys_equal_the_reference(tdt, jdt):
    for name in ("KIND_MATMUL_TC", "KIND_MATMUL_BW", "KIND_CONV_TC", "KIND_CONV_BW",
                 "KIND_CONV_DENSE"):
        assert getattr(tcore, name) == getattr(jcore, name)
    ms, js = tcore.matmul_sig(64, 128, 96, 8, 3, tdt), jcore.matmul_sig(64, 128, 96, 8, 3, jdt)
    assert ms == js
    cs = tcore.conv_sig(2, 16, 16, 32, 64, 3, 3, 1, 1, 8, 3, tdt)
    assert cs == jcore.conv_sig(2, 16, 16, 32, 64, 3, 3, 1, 1, 8, 3, jdt)
    for kind, sig in ((tcore.KIND_MATMUL_TC, ms), (tcore.KIND_CONV_BW, cs)):
        for backend in ("cpu", "cuda"):
            key = tat.cache_key(kind, sig, backend)
            assert key == jat.cache_key(kind, sig, backend=backend)
            assert tat.parse_key(key) == (backend, kind, sig)


def test_key_distinguishes_everything():
    base = tat.cache_key(tcore.KIND_MATMUL_TC, tcore.matmul_sig(64, 128, 96, 8, 3, "int8"), "cuda")
    variants = [
        tat.cache_key(tcore.KIND_MATMUL_BW, tcore.matmul_sig(64, 128, 96, 8, 3, "int8"), "cuda"),
        tat.cache_key(tcore.KIND_MATMUL_TC, tcore.matmul_sig(65, 128, 96, 8, 3, "int8"), "cuda"),
        tat.cache_key(tcore.KIND_MATMUL_TC, tcore.matmul_sig(64, 128, 96, 8, 4, "int8"), "cuda"),
        tat.cache_key(tcore.KIND_MATMUL_TC, tcore.matmul_sig(64, 128, 96, 8, 3, "bfloat16"),
                      "cuda"),
        tat.cache_key(tcore.KIND_MATMUL_TC, tcore.matmul_sig(64, 128, 96, 8, 3, "int8"), "cpu"),
    ]
    assert len({base, *variants}) == len(variants) + 1
    assert tat.parse_key("not a key") is None


# ---------------------------------------------------------------- cache


def _fake_search(monkeypatch, cache, sig, winner, default, *, kind=tcore.KIND_MATMUL_TC):
    """A search over fake builds and timers (``winner`` 50 us, the rest 100,
    confirmed), into ``cache``."""
    monkeypatch.setattr(tat, "median_time_us",
                        lambda fn, *a, **k: 50.0 if fn() == winner else 100.0)
    monkeypatch.setattr(tat, "interleaved_medians", lambda *a, **k: (50.0, 100.0))
    return tat._search(kind, sig, tcore.launch_choices(kind, sig), cost_fn=lambda t: 0.0,
                       build=lambda t: (lambda: t), default_tiles=default, top_k=8, reps=3,
                       warmup=1, cache=cache, save=True)


def test_round_trip_no_new_search(tmp_path, monkeypatch):
    """A searched choice persists, and a later 'cache' or 'search' query of
    the signature (registry cleared) installs it from the file without a
    search."""
    path = tmp_path / "autotune.json"
    sig = tcore.matmul_sig(64, 512, 72, 8, 3, "int8")
    res = _fake_search(monkeypatch, tat.TuneCache(path), sig, {"tile_rows": 128},
                       {"tile_rows": 64})
    assert res.tiles == {"tile_rows": 128} and res.measured_us <= res.default_us
    data = json.loads(path.read_text())
    assert data["version"] == tat.CACHE_VERSION
    assert set(data["entries"]) == {tat.cache_key(tcore.KIND_MATMUL_TC, sig, "cuda")}
    tcore.clear_tuned()
    before = tat.searches()
    for mode in ("cache", "search"):
        got = tat.tiles_for_matmul(64, 512, 72, FMT, torch.int8, mode=mode, cache=path,
                                   device="cuda")
        assert got == {"tile_rows": 128}
    assert tat.searches() == before
    assert tcore.lookup_tiles(tcore.KIND_MATMUL_TC, sig) == {"tile_rows": 128}
    # a miss under 'cache' is the rule's ({}), never a search
    assert tat.tiles_for_matmul(65, 512, 72, FMT, torch.int8, mode="cache", cache=path,
                                device="cuda") == {}
    assert tat.searches() == before


def test_version_mismatch_and_corrupt_file_invalidate(tmp_path):
    path = tmp_path / "autotune.json"
    path.write_text(json.dumps({"version": 999, "entries": {"cuda|x|1": {}},
                                "calibration": {"cuda": {}}}))
    c = tat.TuneCache(path)
    assert c.entries == {} and c.calibration == {}
    path.write_text("{not json")
    c = tat.TuneCache(path)
    assert c.entries == {}
    c.put("cuda|matmul_tc|4x64x72x8x3xint8", {"tiles": {"tile_rows": 64}})
    c.save()  # a corrupt file is replaced whole
    assert tat.TuneCache(path).get("cuda|matmul_tc|4x64x72x8x3xint8") == {
        "tiles": {"tile_rows": 64}}


def test_an_entry_the_kernel_cannot_run_is_dropped_at_load(tmp_path):
    path = tmp_path / "autotune.json"
    good = "cuda|matmul_tc|4x64x72x8x3xint8"
    bad = {"cuda|matmul_tc|4x64x72x8x3xint8x": {"tiles": {"tile_rows": 64}},
           "cuda|matmul_tc|5x64x72x8x3xint8": {"tiles": {"tile_rows": 96}},
           "cuda|matmul_tc|6x64x72x8x3xbfloat16": {"tiles": {"tile": "small", "split": 7}},
           "cuda|conv_dense|1x16x16x16x32x3x3x1x1x0x0xfloat32": {"tiles": {"path": "direct"}},
           "cuda|matmul_tc|7x64x72x8x3xfloat32": {"tiles": {"tile_rows": 64}},
           "cuda|matmul_tc|8x64x72x8x3xint8": {"no tiles": 1}}
    ref_entry = {"tiles": {"bm": 8, "bn": 72, "kb": 2}}
    path.write_text(json.dumps({"version": 1, "calibration": {}, "entries": {
        good: {"tiles": {"tile_rows": 64}}, "cpu|matmul_tc|4x64x72x8x3xint8": ref_entry,
        **bad}}))
    c = tat.TuneCache(path)
    assert set(c.entries) == {good, "cpu|matmul_tc|4x64x72x8x3xint8"}
    c.save()
    assert set(json.loads(path.read_text())["entries"]) == set(c.entries)


def test_one_file_shared_with_the_reference(tmp_path, monkeypatch):
    """The reference's ``cpu|…`` entries and the port's ``cuda|…`` entries
    in one file: each package's save keeps the other's, also an entry the
    other wrote after this one loaded."""
    path = tmp_path / "autotune.json"
    jkey = jat.cache_key(jcore.KIND_MATMUL_TC, jcore.matmul_sig(64, 128, 96, 8, 3, jnp.float32),
                         backend="cpu")
    jentry = {"tiles": {"bm": 64, "bn": 96, "kb": 16}, "measured_us": 1.0}
    port = tat.TuneCache(path)  # loaded before the reference writes
    ref = jat.TuneCache(path)
    ref.put(jkey, jentry)
    ref.calibration["cpu"] = {"version": 1, "peak_macs": 1.0}
    ref.save()
    sig = tcore.matmul_sig(4, 512, 72, 8, 3, "int8")
    _fake_search(monkeypatch, port, sig, {"tile_rows": 128}, {"tile_rows": 64})
    port.calibration["cuda"] = {"version": 1, "peak_macs": 2.0}
    port.save()
    data = json.loads(path.read_text())
    tkey = tat.cache_key(tcore.KIND_MATMUL_TC, sig, "cuda")
    assert data["entries"][jkey] == jentry and tkey in data["entries"]
    assert set(data["calibration"]) == {"cpu", "cuda"}
    ref = jat.TuneCache(path)  # the reference keeps the port's entry through its save
    ref.put(jkey, dict(jentry, measured_us=2.0))
    ref.save()
    again = tat.TuneCache(path)
    assert again.get(tkey)["tiles"] == {"tile_rows": 128}
    assert again.get(jkey)["measured_us"] == 2.0


# -------------------------------------------------------- candidates


def _cnn_launches(pattern):
    """(kind, sig) of every stage of sparse-cnn-s at buckets 1 … 64 (the
    shapes chip_smoke's phase 13 searches)."""
    cfg = get_cnn_config("sparse-cnn-s", pattern=pattern)
    model = SparseCNN(cfg)
    layers = model.layers()
    for b in (1, 2, 4, 8, 16, 32, 64):
        h = w = cfg.image_size
        for i, m in enumerate(layers[:-1]):
            (sh, sw), _, (ho, wo) = tcore.conv_geometry(h, w, m.kh, m.kw, m.stride, m.padding)
            if i == 0:
                yield tcore.KIND_CONV_DENSE, tcore.conv_sig(b, ho, wo, m.in_channels,
                                                            m.out_channels, m.kh, m.kw, sh, sw,
                                                            0, 0, "float32")
            else:
                kind = tcore.KIND_CONV_TC if pattern == "matrix" else tcore.KIND_CONV_BW
                yield kind, tcore.conv_sig(b, ho, wo, m.in_channels, m.out_channels, m.kh, m.kw,
                                           sh, sw, 8, 3, "int8")
            h, w = ho, wo
        head = layers[-1]
        kind = tcore.KIND_MATMUL_TC if pattern == "matrix" else tcore.KIND_MATMUL_BW
        yield kind, tcore.matmul_sig(b, head.in_features, head.out_features, 8, 3, "int8")


LM_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)]


def _lm_launches():
    for m in (4, 1024):
        for k, n in LM_SHAPES:
            for dt in ("bfloat16", "int8"):
                yield tcore.KIND_MATMUL_TC, tcore.matmul_sig(m, k, n, 8, 3, dt)


@pytest.mark.parametrize("pattern", ["matrix", None])
def test_default_is_todays_rule_at_the_cnn_shapes(pattern):
    """At every stage and bucket chip_smoke searches, every candidate is
    legal, and the default is the choice the plans make with an empty
    registry: 64 tile rows up to M = 64, else 128; the stem direct."""
    n = 0
    for kind, sig in _cnn_launches(pattern):
        cands = tcore.launch_choices(kind, sig)
        for t in cands:
            assert tcore.check_choice(kind, sig, t) == t
        d = tcore.default_choice(kind, sig)
        assert d in cands
        if kind == tcore.KIND_CONV_DENSE:
            assert d == {"path": stem_k.conv_path(torch.float32, sig[3], sig[5], sig[6],
                                                  (sig[7], sig[8]))} == {"path": "direct"}
            assert cands == [{"path": "direct"}, {"path": "gemm"}]
        else:
            m = sig[0] if kind.startswith("matmul") else sig[0] * sig[1] * sig[2]
            assert d == {"tile_rows": tcore.mma_plan("k", m, 8, 8, 0).tile_rows}
            assert d == {"tile_rows": 64 if m <= 64 else 128}
            assert cands == [{"tile_rows": 64}, {"tile_rows": 128}]
        n += 1
    assert n == 7 * 9


def test_default_is_todays_rule_at_the_lm_shapes():
    for kind, sig in _lm_launches():
        m, k, n, _, _, dt = sig
        kc = k // 8 * 3
        d = tcore.default_choice(kind, sig)
        cands = tcore.launch_choices(kind, sig)
        assert d in cands
        if dt == "int8":
            assert d == {"tile_rows": tcore.mma_gather_plan("k", m, kc).tile_rows}
        else:
            plan = tcore.bf16_mma_plan("k", m, n, kc, (0, 0), k=k)
            assert d == tcore.bf16_choice(plan)
            stages = -(-kc // 32)
            assert len(cands) == min(16, stages) + min(8, stages)


def test_no_choice_where_the_launch_takes_none():
    """fp32 products run the CUDA-core loop: no choice, nothing to tune or
    install; the fp32 dense conv at a C the direct path cannot hold has
    the GEMM alone."""
    sig = tcore.matmul_sig(64, 512, 72, 8, 3, "float32")
    assert tcore.launch_choices(tcore.KIND_MATMUL_TC, sig) == []
    assert tcore.default_choice(tcore.KIND_MATMUL_TC, sig) is None
    assert tat.tiles_for_matmul(64, 512, 72, FMT, torch.float32, mode="search",
                                device="cuda") == {}
    big = tcore.conv_sig(1, 16, 16, 16, 32, 3, 3, 1, 1, 0, 0, "float32")
    assert tcore.launch_choices(tcore.KIND_CONV_DENSE, big) == [{"path": "gemm"}]
    with pytest.raises(ValueError, match="kind"):
        tcore.launch_choices("matmul_fancy", sig)


def test_search_always_measures_the_default(monkeypatch):
    """The default is measured even when the model ranks it last and
    ``top_k`` keeps one, and even when it is not among the candidates."""
    sig = tcore.matmul_sig(4, 4608, 4608, 8, 3, "bfloat16")
    default = tcore.default_choice(tcore.KIND_MATMUL_TC, sig)
    timed = []
    monkeypatch.setattr(tat, "median_time_us", lambda fn, *a, **k: (timed.append(fn()), 10.0)[1])
    others = [t for t in tcore.launch_choices(tcore.KIND_MATMUL_TC, sig) if t != default]
    res = tat._search(tcore.KIND_MATMUL_TC, sig, others,
                      cost_fn=lambda t: 1.0 if t == default else 0.0,
                      build=lambda t: (lambda: t), default_tiles=default, top_k=1, reps=1,
                      warmup=0, cache=None, save=False)
    assert default in timed and len(timed) == 2
    assert res.tiles == default and res.n_candidates == len(others) + 1
    assert res.measured_us == res.default_us


def test_search_checks_every_choice_before_timing_it(monkeypatch):
    sig = tcore.matmul_sig(64, 512, 72, 8, 3, "int8")
    order = []
    monkeypatch.setattr(tat, "median_time_us", lambda fn, *a, **k: (order.append(("t", fn())),
                                                                    10.0)[1])

    def check(t):
        order.append(("c", t))
        if t == {"tile_rows": 128}:
            raise AssertionError("a wrong choice")

    with pytest.raises(AssertionError, match="wrong"):
        tat._search(tcore.KIND_MATMUL_TC, sig, tcore.launch_choices(tcore.KIND_MATMUL_TC, sig),
                    cost_fn=lambda t: t["tile_rows"], build=lambda t: (lambda: t),
                    default_tiles={"tile_rows": 64}, top_k=2, reps=1, warmup=0, cache=None,
                    save=False, check=check)
    assert order == [("c", {"tile_rows": 64}), ("t", {"tile_rows": 64}),
                     ("c", {"tile_rows": 128})]
    assert tcore.lookup_tiles(tcore.KIND_MATMUL_TC, sig) is None


def test_nothing_is_tuned_on_the_cpu(tmp_path):
    path = tmp_path / "autotune.json"
    for mode in ("off", "cache", "search"):
        assert tat.tiles_for_matmul(4, 512, 72, FMT, torch.int8, mode=mode, cache=path,
                                    device="cpu") == {}
        assert tat.tiles_for_conv(1, 16, 16, 3, 32, 3, 3, None, torch.float32, mode=mode,
                                  cache=path, device="cpu") == {}
    with pytest.raises(ValueError, match="CPU"):
        tat.tune_matmul(4, 512, 72, FMT, dtype=torch.int8, cache=path, device="cpu")
    with pytest.raises(ValueError, match="tune"):
        tat.tiles_for_matmul(4, 512, 72, FMT, torch.int8, mode="fast", device="cpu")
    assert tcore.tuned_entries() == {} and not path.exists()


def test_modeled_costs_rank_by_the_three_terms():
    """More rows of waste cost more MACs; a split adds waves; the cost under
    a calibration is max(compute, memory) + steps · overhead."""
    from repro_torch.kernels import calibrate

    cal = calibrate.default_calibration("cuda")
    small = tat.matmul_cost_terms(4, 4608, 4608, FMT, {"tile": "small", "split": 1}, 2.0)
    large = tat.matmul_cost_terms(4, 4608, 4608, FMT, {"tile": "large", "split": 1}, 2.0)
    assert large[0] > small[0]
    macs, bytes_, steps = small
    assert tat.modeled_matmul_cost(4, 4608, 4608, FMT, {"tile": "small", "split": 1}, 2.0,
                                   cal=cal) == pytest.approx(
        max(macs / cal.peak_macs, bytes_ / cal.hbm_bw) + steps * cal.step_overhead_s)
    a, b = (tat.conv_cost_terms(64, 64, 64, 64, 64, 3, 3, 1, 1, FMT, {"tile_rows": r}, 1.0)
            for r in (64, 128))
    assert a[2] != b[2]
    d, g = (tat.conv_cost_terms(1, 16, 16, 3, 32, 3, 3, 1, 1, None, {"path": p}, 4.0)
            for p in ("direct", "gemm"))
    assert d == g


# -------------------------------------------------------------- registry


def test_registry_reaches_the_plans_and_refuses_invalid_entries():
    mkey = (tcore.KIND_MATMUL_BW, tcore.matmul_sig(4, 576, 64, 8, 3, "int8"))
    gkey = (tcore.KIND_MATMUL_TC, tcore.matmul_sig(4, 512, 72, 8, 3, "int8"))
    tkey = (tcore.KIND_CONV_TC, tcore.conv_sig(1, 8, 8, 64, 64, 3, 3, 1, 1, 8, 3, "int8"))
    bkey = (tcore.KIND_MATMUL_TC, tcore.matmul_sig(4, 4608, 4608, 8, 3, "bfloat16"))
    skey = (tcore.KIND_CONV_DENSE, tcore.conv_sig(1, 16, 16, 3, 32, 3, 3, 1, 1, 0, 0, "float32"))
    assert tcore.mma_plan("k", 4, 576, 64, 0, key=mkey).tile_rows == 64
    assert tcore.bf16_mma_plan("k", 4, 4608, 1728, (0, 0), k=4608, key=bkey).split == 4
    tcore.set_tuned(*mkey, {"tile_rows": 128})
    tcore.set_tuned(*gkey, {"tile_rows": 128})
    tcore.set_tuned(*tkey, {"tile_rows": "128"})  # normalized
    tcore.set_tuned(*bkey, {"tile": "large", "split": 3})
    tcore.set_tuned(*skey, {"path": "gemm"})
    assert tcore.lookup_tiles(*tkey) == {"tile_rows": 128}
    assert tcore.mma_plan("k", 4, 576, 64, 0, key=mkey).tile_rows == 128
    assert tcore.mma_gather_plan("k", 4, 192, key=gkey).tile_rows == 128
    assert tcore.mma_tap_plan("k", 64, 216, 3, 3, 8, 64, key=tkey).tile_rows == 128
    plan = tcore.bf16_mma_plan("k", 4, 4608, 1728, (0, 0), k=4608, key=bkey)
    assert (plan.tile_rows, plan.tile_cols, plan.split) == (128, 256, 3)
    assert stem_k.conv_path(torch.float32, 3, 3, 3, 1, key=skey) == "gemm"
    # a plan's own choice wins over the registry; {} asks for the rule
    assert tcore.mma_plan("k", 4, 576, 64, 0, key=mkey, choice={}).tile_rows == 64
    assert tcore.mma_plan("k", 4, 576, 64, 0, key=mkey,
                          choice={"tile_rows": 64}).tile_rows == 64
    assert stem_k.conv_path(torch.float32, 3, 3, 3, 1, key=skey, choice={}) == "direct"
    with pytest.raises(ValueError, match="path"):
        stem_k.conv_path(torch.float32, 16, 3, 3, 1, choice={"path": "direct"})
    before = tcore.tuned_entries()
    for key, bad in ((mkey, {"tile_rows": 96}), (mkey, {"tile": "small", "split": 1}),
                     (bkey, {"tile": "small", "split": 17}), (bkey, {"tile": "huge", "split": 1}),
                     (bkey, {"tile": "large", "split": 0}), (skey, {"path": "fft"}),
                     ((tcore.KIND_CONV_DENSE, skey[1][:3] + (16,) + skey[1][4:]),
                      {"path": "direct"}), (mkey, {"tile_rows": "many"}), (mkey, {})):
        with pytest.raises(ValueError):
            tcore.set_tuned(*key, bad)
    assert tcore.tuned_entries() == before
    tcore.clear_tuned()
    assert tcore.mma_plan("k", 4, 576, 64, 0, key=mkey).tile_rows == 64


def test_a_built_plan_keeps_its_choices_when_the_registry_changes():
    """A stage's choice is frozen at its build: installing other choices
    afterwards changes no built stage's tiles, graphed or eager."""
    from repro_torch.kernels import ops
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import dbb_encode

    qw = quantize_dbb(dbb_encode(torch.randn(512, 72), FMT, prune=True))
    run, tiles = ops.stage_quant_matmul(qw, torch.tensor(0.02), 4)
    assert tiles["tile_rows"] == 64
    tcore.set_tuned(tcore.KIND_MATMUL_TC, tcore.matmul_sig(4, 512, 72, 8, 3, "int8"),
                    {"tile_rows": 128})
    assert ops.stage_quant_matmul(qw, torch.tensor(0.02), 4)[1]["tile_rows"] == 128
    assert ops.stage_quant_matmul(qw, torch.tensor(0.02), 4, choice={})[1]["tile_rows"] == 64
    assert tiles["tile_rows"] == 64
    x = torch.randn(4, 512)
    assert torch.equal(run(x), ops.quant_matmul(x, qw, torch.tensor(0.02)))


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("pattern,fixture", [("matrix", tp.FIXTURE), (None, tp.FIXTURE_BW)],
                         ids=["tc", "bw"])
@pytest.mark.parametrize("tune", ["cache", "search"])
def test_tuned_plans_match_off_and_the_jax_plan(pattern, fixture, tune, tmp_path):
    """On the fixtures' parameters the port's plan set and plan under
    ``tune`` equal its ``'off'`` ones bit for bit (nothing tuned on the
    CPU), and match the JAX package's ``tune='off'`` plan set within the
    fixtures' 1e-3 relative L2."""
    with np.load(fixture) as z:
        tree = unflatten(z)
    jmodel = JSparseCNN(dataclasses.replace(tp.chain_config(pattern), kernel_mode="ref"))
    jset = jmodel.plan_set(tp.from_numpy(tree["params"]), buckets=(1, 2, 4), tune="off")
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                              convs_per_stage=2)
    model = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], "cpu"))
    cache = tmp_path / "autotune.json"
    tset = model.plan_set(buckets=(1, 2, 4), tune=tune, cache=cache)
    off = model.plan_set(buckets=(1, 2, 4), tune="off")
    assert tset.tiles == off.tiles
    x = np.random.default_rng(5).normal(size=(5, 16, 16, 3)).astype(np.float32)
    for n in (3, 5):
        got = tset.serve(x[:n])
        assert np.array_equal(got, off.serve(x[:n]))
        want = np.asarray(jset.serve(x[:n]), np.float64)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
    xt = torch.from_numpy(x[:2])
    assert torch.equal(model.plan(batch=2, tune=tune, cache=cache)(xt),
                       model.plan(batch=2, tune="off")(xt))
    assert tcore.tuned_entries() == {} and not cache.exists()


def test_lm_plan_tune_modes_equal_off_on_the_cpu():
    """``LM.plan`` under 'cache' and 'search' (``_tune_gemms`` measures
    nothing on the CPU) equals 'off' bit for bit."""
    model = serve.build_lm("starcoder2-7b", device="cpu", smoke=True)
    tokens = serve.prompt_tokens(model, batch=2, seq=16)["tokens"]
    with torch.no_grad():
        _, stats = model.forward(tokens, collect_act_stats=True)
    model.quantize(stats)
    with torch.no_grad():
        want = model.plan(batch=2, seq=16, tune="off")(tokens)
        for tune in ("cache", "search"):
            assert torch.equal(model.plan(batch=2, seq=16, tune=tune)(tokens), want)
    assert tcore.tuned_entries() == {}


# ------------------------------------------------------------------ serve


def test_serve_cli_takes_tune_with_the_default_cache(monkeypatch):
    seen = []
    monkeypatch.setattr(serve, "serve", lambda *a, **kw: seen.append(("serve", kw["tune"])))
    monkeypatch.setattr(serve, "serve_lm_plan",
                        lambda *a, **kw: seen.append(("lm_plan", kw["tune"])))
    serve.main(["--arch", "sparse-cnn-s"])
    serve.main(["--arch", "sparse-cnn-s", "--tune", "search"])
    serve.main(["--arch", "starcoder2-7b", "--lm-plan", "--tune", "off"])
    assert seen == [("serve", "cache"), ("serve", "search"), ("lm_plan", "off")]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "sparse-cnn-s", "--tune", "fast"])


@pytest.mark.parametrize("tune,reload_tune", [("search", "cache"), ("cache", "cache"),
                                              ("off", "off")])
def test_serve_continuous_reloads_with_cache_after_a_search(monkeypatch, tune, reload_tune):
    """A hot reload rebuilds the plan set with ``'cache'`` after a
    ``'search'`` build (it takes what the search persisted, never searching
    again), else with the build's own mode, as the reference's."""
    model, x = serve.build_model("sparse-cnn-tiny", calib_batch=4, device="cpu", smoke=True)
    ps = model.plan_set(max_batch=4, tune=tune)
    modes = []
    plan_set = SparseCNN.plan_set

    def recorded(self, **kw):
        modes.append(kw.get("tune"))
        return plan_set(self, **kw)

    monkeypatch.setattr(SparseCNN, "plan_set", recorded)
    xs = x.numpy()
    requests = [xs[i % 4][None] for i in range(8)]
    out = serve.serve_continuous(ps, requests, rate=2000.0, max_wait_ms=1.0, model=model,
                                 reload_every=4, tune=tune, log=lambda *_: None)
    assert out["failures"] == {} and len(out["reloads"]) == 1
    assert modes == [reload_tune]
