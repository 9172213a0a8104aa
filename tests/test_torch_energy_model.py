"""repro_torch.core.energy_model and ``SparseCNN.layer_costs`` held against
repro.core.energy_model and the reference's ``layer_costs`` on the CPU.

The accounting is plain Python and integer arithmetic, so every output is
compared with ``==``, key by key: every ``STAConfig`` property and method
over the designs ``benchmarks/bench_design_space.py`` sweeps (both
technologies, with and without activation clock gating, nnz 1 … 8, scalar
and measured activation sparsities), ``conv_workload`` and
``model_workload``, and ``layer_costs`` of ``sparse-cnn-tiny`` from the
golden fixture ``tests/data/torch_parity_cnn.npz``, with the stats each
package measures on the fixture's input (equal: 0 differences) and without.
Table V is held within 5 %, as ``tests/test_system.py::TestEnergyModel``
holds the reference.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from benchmarks.bench_design_space import candidates
from repro.core import act_sparsity as ja
from repro.core import energy_model as je
from repro.core import vdbb as jv
from repro.models.cnn import SparseCNN as JSparseCNN
from repro_torch.configs import cnn as tcfg
from repro_torch.core import act_sparsity as ta
from repro_torch.core import energy_model as te
from repro_torch.core import vdbb as tv
from repro_torch.interop import params_from_numpy, unflatten
from repro_torch.models.cnn import SparseCNN

PROPS = ("bz", "macs_per_tpe", "accs_per_tpe", "oprs_per_tpe", "muxes_per_tpe", "total_macs")
NULLARY = ("inter_tpe_reuse", "intra_tpe_reuse", "peak_tops", "_n_mcu",
           "_datapath_cost_units", "_ref_datapath_cost_units", "area_mm2")
ACTS = (None, 0.0, 0.3, 0.5, 0.8, 1.0)


def _designs():
    out = []
    for name, d in candidates():
        for tech in ("16nm", "65nm"):
            for act_cg in (True, False):
                out.append((f"{name}-{tech}-{'cg' if act_cg else 'nocg'}",
                            dataclasses.replace(d, tech=tech, act_cg=act_cg)))
    return out


DESIGNS = _designs()


def _port(design):
    return te.STAConfig(**dataclasses.asdict(design))


def test_constants_are_the_references():
    assert te.REF == je.REF and te.UNIT == je.UNIT and te.TECH == je.TECH
    assert te.STA_UNGATEABLE_FRAC == je.STA_UNGATEABLE_FRAC
    assert te.VDBB_MAC_FACTOR == je.VDBB_MAC_FACTOR
    assert te.PAPER_TABLE_V_16NM == je.PAPER_TABLE_V_16NM
    assert te.PAPER_TABLE_V_65NM == je.PAPER_TABLE_V_65NM
    assert dataclasses.asdict(te.PARETO_DESIGN) == dataclasses.asdict(je.PARETO_DESIGN)
    assert not hasattr(te, "TPU_V5E")  # a TPU's roofline: not the port's


@pytest.mark.parametrize("name,design", DESIGNS, ids=[n for n, _ in DESIGNS])
def test_every_sta_output_equals_the_reference(name, design):
    port = _port(design)
    for p in PROPS:
        assert getattr(port, p) == getattr(design, p), p
    for f in NULLARY:
        assert getattr(port, f)() == getattr(design, f)(), f
    for nnz in range(1, 9):
        jf, tf = jv.DBBFormat(8, nnz), tv.DBBFormat(8, nnz)
        assert port.speedup(tf) == design.speedup(jf)
        assert port.effective_tops(tf) == design.effective_tops(jf)
        assert port.tops_per_mm2(tf) == design.tops_per_mm2(jf)
        for act in ACTS:
            kw = {} if act is None else {"act_sparsity": act}
            assert port.power_mw(tf, **kw) == design.power_mw(jf, **kw), (nnz, act)
            assert port.tops_per_w(tf, **kw) == design.tops_per_w(jf, **kw), (nnz, act)
        # a measured ActStats stands where a scalar does, in both packages
        assert (port.power_mw(tf, ta.ActStats(zero_frac=0.3))
                == design.power_mw(jf, ja.ActStats(zero_frac=0.3)))


@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.625, 0.75, 0.875, 0.95])
def test_fmt_for_sparsity_matches(sparsity):
    got, want = te.fmt_for_sparsity(sparsity), je.fmt_for_sparsity(sparsity)
    assert (got.bz, got.nnz, got.group) == (want.bz, want.nnz, want.group)


def test_table_v_within_5pct():
    for sp, (tw, tm) in te.PAPER_TABLE_V_16NM.items():
        f = te.fmt_for_sparsity(sp)
        assert te.PARETO_DESIGN.tops_per_w(f) == pytest.approx(tw, rel=0.05)
        assert te.PARETO_DESIGN.tops_per_mm2(f) == pytest.approx(tm, rel=0.05)


def test_vdbb_beats_fixed_dbb_above_design_point():
    vdbb = te.STAConfig(4, 8, 4, 8, 8, mode="vdbb")
    dbb = te.STAConfig(4, 8, 4, 4, 8, mode="dbb", hw_nnz=4)
    hi, lo = te.fmt_for_sparsity(0.875), te.fmt_for_sparsity(0.25)
    assert vdbb.effective_tops(hi) > dbb.effective_tops(hi) * 1.9
    assert dbb.effective_tops(lo) == dbb.peak_tops()
    assert vdbb.effective_tops(lo) > dbb.effective_tops(lo)


# ------------------------------------------------------- the CNN's accounting


@pytest.fixture(scope="module")
def fixture_models():
    """The golden fixture's quantized sparse-cnn-tiny in both packages and
    the activation stats each measures on the fixture's input."""
    with np.load(tp.FIXTURE) as z:
        tree = unflatten(z)
    jm = JSparseCNN(tp.chain_config())
    _, jstats = jm.apply(tp.from_numpy(tree["params"]), jnp.asarray(tree["input"]),
                         collect_act_stats=True)
    cfg = dataclasses.replace(tcfg.smoke_cnn_config("sparse-cnn-tiny"), convs_per_stage=2)
    tm = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], "cpu"))
    with torch.no_grad():
        _, tstats = tm(torch.from_numpy(tree["input"]), collect_act_stats=True)
    return jm, jstats, tm, tstats


def test_the_fixture_stats_agree(fixture_models):
    _, jstats, _, tstats = fixture_models
    assert len(jstats) == len(tstats)
    for j, t in zip(jstats, tstats):
        assert (t.name, t.shape, t.numel, t.macs) == (j.name, j.shape, j.numel, j.macs)
        assert t.zero_frac == j.zero_frac
        np.testing.assert_equal(t.block_nnz_mean, j.block_nnz_mean)  # NaN at the C = 3 stem


def _costs_equal(got, want):
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (_, gc, gf), (_, wc, wf) in zip(got, want):
        assert (gf.bz, gf.nnz, gf.group) == (wf.bz, wf.nnz, wf.group)
        assert gc == wc


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kw", [{}, {"bits": 8, "act_bits": 8, "epilogue_fused": True},
                                {"bits": 32}, {"bits": 8, "act_bits": 32}])
def test_layer_costs_and_model_workload_equal_the_references(fixture_models, stats, kw):
    jm, jstats, tm, tstats = fixture_models
    want = jm.layer_costs(4, stats=jstats if stats else None, **kw)
    got = tm.layer_costs(4, stats=tstats if stats else None, **kw)
    _costs_equal(got, want)
    assert all(c["act_measured"] == stats for _, c, _ in got)
    for design in (te.PARETO_DESIGN, _port(DESIGNS[0][1]), _port(DESIGNS[5][1])):
        jdesign = je.STAConfig(**dataclasses.asdict(design))
        w_t = te.model_workload(design, [(c, f, None) for _, c, f in got])
        w_j = je.model_workload(jdesign, [(c, f, None) for _, c, f in want])
        assert w_t == w_j
        # and with the stats passed per layer, as the benchmarks compose them
        layers = [(c, f, tstats[int(n[1:])] if stats else 0.5) for n, c, f in got]
        jlayers = [(c, f, jstats[int(n[1:])] if stats else 0.5) for n, c, f in want]
        assert te.model_workload(design, layers) == je.model_workload(jdesign, jlayers)


def test_measured_sparsity_raises_the_paper_design_efficiency(fixture_models):
    """The fixture's post-ReLU activations are sparser than the paper's
    assumed 0.5 at the convs after the stem, so the measured TOPS/W of the
    pareto design exceeds the assumed one; the stem reads the dense
    image."""
    _, _, tm, tstats = fixture_models
    measured = te.model_workload(te.PARETO_DESIGN,
                                 [(c, f, None) for _, c, f in tm.layer_costs(4, stats=tstats)])
    assumed = te.model_workload(te.PARETO_DESIGN,
                                [(c, f, None) for _, c, f in tm.layer_costs(4)])
    assert assumed["mean_act_sparsity"] == 0.5
    convs = tm.layer_costs(4)
    assert measured["mean_act_sparsity"] == pytest.approx(
        sum(tstats[int(n[1:])].zero_frac * c["executed_macs"] for n, c, _ in convs)
        / sum(c["executed_macs"] for _, c, _ in convs))
    assert (measured["tops_per_w"] > assumed["tops_per_w"]) == (
        measured["mean_act_sparsity"] > 0.5)
