"""Analytic area / power / throughput model of the VDBB accelerator (port
of ``repro/core/energy_model.py``, copied constant for constant: these are
the paper's 16 nm and 65 nm ASIC figures, not timings of any chip this
package runs on).

Reproduces the paper's evaluation artifacts (Table III reuse formulas,
Table IV component breakdown, Table V headline efficiencies, Fig 9/10
design space, Fig 12 sparsity scaling) from a component-level model.

Calibration. The paper reports, for the pareto design 4x8x8_4x8 VDBB+IM2C
at nominal 4 TOPS / 1 GHz / 16nm (Table IV, 3/8 DBB, 50% act sparsity):

    STA 318 mW / 0.732 mm2,  W-SRAM 78.5 mW / 0.54 mm2,
    A-SRAM 31.0 mW (93.0 w/o IM2COL) / 2.16 mm2,
    4x M33 50.5 mW / 0.30 mm2,  IM2COL 10.0 mW / 0.01 mm2.

Table V gives effective TOPS/W at weight sparsity {50, 62.5, 75, 87.5}% =
{16.8, 21.9, 31.3, 55.7}. Inverting (effective TOPS = 4 * bz/nnz) yields
total power {476, 487, 511, 574} mW — an almost exact linear function of
the speedup s = bz/nnz:  P(s) = 443 + 16.4*s mW, whose constant term equals
STA + W-SRAM + MCU (447 mW) and whose linear term at s=8/3 equals
A-SRAM + IM2COL (41 mW). I.e. the *activation stream* is the only component
whose per-cycle bandwidth scales with speedup; weight stream and datapath
are constant per cycle — precisely the paper's "constant utilization,
variable occupancy" claim. The model below encodes exactly that structure.

The reference's ``TPU_V5E`` roofline constants are not copied: they describe
a TPU. The H100 constants this package measures against live in
``kernels/calibrate.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.vdbb import DBBFormat, _act_sparsity_frac

# ---------------------------------------------------------------------------
# Calibrated component constants (16nm, 1 GHz, from Table IV)
# ---------------------------------------------------------------------------

REF = dict(  # pareto design 4x8x8_4x8 VDBB IM2C
    A=4, B=8, C=8, M=4, N=8,
    sta_mw=318.0, sta_mm2=0.732,
    wsram_mw=78.5, wsram_mm2=0.54,
    asram_mw=31.0, asram_mw_noim2c=93.0, asram_mm2=2.16,
    mcu_mw_each=50.5 / 4, mcu_mm2_each=0.30 / 4,
    im2col_mw=10.0, im2col_mm2=0.01,
    ref_speedup=8.0 / 3.0,      # 3/8 DBB
    ref_act_sparsity=0.5,
)

# Fraction of STA power that is *not* gateable by activation-sparsity clock
# gating (clock tree, registers, control). Chosen so Fig 12(b)'s 80%-act
# curves sit visibly above the 50% ones without exceeding them by >20%.
STA_UNGATEABLE_FRAC = 0.45

# Relative datapath unit costs (normalized to one INT8 MAC = 1.0).
# A 4:1 INT8 mux is "significantly less than a MAC" (paper SIV-A2).
UNIT = dict(mac=1.0, acc_reg_bit=0.055, opr_reg_bit=0.035, mux4=0.18, mux8=0.28)

# The paper states the 4x8x8_4x8 VDBB design is "nominal 4 TOPS" although
# A*C*M*N = 1024 MACs = 2.048 TOPS; we calibrate a x2 MAC-equivalence factor
# for the time-unrolled lanes (consistent with *both* 65nm Table V rows and
# the iso-throughput normalization of Fig 9, where the 1x1x1_32x64 baseline
# and the DBB 4x8x4_4x8 design are also 2048 MACs).
VDBB_MAC_FACTOR = 2

# 65nm scaling (paper also reports a 65nm implementation at 0.5 GHz).
# energy_scale solved from Table V: 62.5% row gives 5.46 TOPS eff / 1.95
# TOPS/W -> 2.80 W = P16(s=8/3) * scale * 0.5 -> scale = 11.47; the 75% row
# then predicts 2.80 TOPS/W exactly as published. area_scale from TOPS/mm2.
TECH = {
    "16nm": dict(freq_ghz=1.0, energy_scale=1.0, area_scale=1.0),
    "65nm": dict(freq_ghz=0.5, energy_scale=12.11, area_scale=8.93),
}


def _act_frac(act) -> float:
    """Scalar activation sparsity from a float or an ActStats-like object
    (single source of truth: ``vdbb._act_sparsity_frac``). Every
    ``act_sparsity=`` parameter below accepts either."""
    return _act_sparsity_frac(0.5 if act is None else act)


@dataclasses.dataclass(frozen=True)
class STAConfig:
    """An A x B x C _ M x N systolic tensor array design point.

    mode: 'dense' | 'dbb' (fixed NNZ at design time) | 'vdbb' (time unrolled)
    """

    A: int = 4
    B: int = 8
    C: int = 8
    M: int = 4
    N: int = 8
    mode: str = "vdbb"
    hw_nnz: int = 4          # only for mode='dbb' (e.g. 4/8 fixed)
    im2col: bool = True
    act_cg: bool = True
    tech: str = "16nm"

    # ---------------- Table III formulas ----------------
    @property
    def bz(self) -> int:
        return self.B

    @property
    def macs_per_tpe(self) -> int:
        if self.mode == "dense":
            return self.A * self.B * self.C
        if self.mode == "dbb":
            return self.A * self.hw_nnz * self.C
        return self.A * self.C  # vdbb: single-MAC S8DP1 units

    @property
    def accs_per_tpe(self) -> int:
        return self.A * self.C

    @property
    def oprs_per_tpe(self) -> int:
        if self.mode == "dense":
            return self.B * (self.A + self.C)
        if self.mode == "dbb":
            return self.A * self.B + self.hw_nnz * self.C
        return self.A * self.B + 1 * self.C  # n=1 weight element per cycle

    @property
    def muxes_per_tpe(self) -> int:
        if self.mode == "dense":
            return 0
        return self.macs_per_tpe  # one activation mux per (S)MAC

    @property
    def total_macs(self) -> int:
        """MAC-equivalents for throughput accounting (see VDBB_MAC_FACTOR)."""
        f = VDBB_MAC_FACTOR if self.mode == "vdbb" else 1
        return f * self.macs_per_tpe * self.M * self.N

    def inter_tpe_reuse(self) -> float:
        a, c, m, n = self.A, self.C, self.M, self.N
        b = {"dense": self.B, "dbb": self.hw_nnz, "vdbb": 1}[self.mode]
        return (a * b * c * m * n) / (a * self.B * m + c * b * n)

    def intra_tpe_reuse(self) -> float:
        a, c = self.A, self.C
        b = {"dense": self.B, "dbb": self.hw_nnz, "vdbb": 1}[self.mode]
        return (a * b * c) / (a * self.B + b * c)

    # ---------------- throughput ----------------
    def peak_tops(self) -> float:
        """Nominal dense-equivalent TOPS (2 ops per executed MAC).

        All modes can run dense GEMM at this rate (a fixed-DBB datapath
        processes a bz-block in bz/hw_nnz passes with all MACs busy), so
        this is the iso-throughput normalization the paper uses in Fig 9.
        """
        freq = TECH[self.tech]["freq_ghz"]
        return 2 * self.total_macs * freq * 1e9 / 1e12

    def effective_tops(self, fmt: DBBFormat) -> float:
        """Effective throughput for a model with weight format ``fmt``.

        Fig 12(a) behaviour: dense SA ignores sparsity; fixed DBB gives a
        step at its design point (less-sparse models fall back to dense,
        sparser ones are capped); VDBB scales continuously as bz/nnz.
        """
        dense_tops = self.peak_tops()
        if self.mode == "dense":
            return dense_tops
        if self.mode == "dbb":
            if fmt.nnz > self.hw_nnz:
                return dense_tops  # dense fallback, no benefit (paper SII-D)
            return dense_tops * self.B / self.hw_nnz
        return dense_tops * self.B / fmt.nnz

    def speedup(self, fmt: DBBFormat) -> float:
        if self.mode == "vdbb":
            return self.B / fmt.nnz
        if self.mode == "dbb":
            return self.B / self.hw_nnz if fmt.nnz <= self.hw_nnz else 1.0
        return 1.0

    def _n_mcu(self) -> int:
        """Paper SIV-D: 2 MCUs for 2 TOPS peak, 4 for 4 TOPS, 8 for 16 TOPS."""
        p = self.peak_tops()
        if p <= 2.5:
            return 2
        if p <= 8.0:
            return 4
        return 8

    # ---------------- power ----------------
    def _datapath_cost_units(self) -> float:
        """Relative datapath cost (MACs + registers + muxes) per TPE."""
        mux = UNIT["mux8"] if self.B == 8 else UNIT["mux4"]
        return (
            self.macs_per_tpe * UNIT["mac"]
            + self.accs_per_tpe * 32 * UNIT["acc_reg_bit"]
            + self.oprs_per_tpe * 8 * UNIT["opr_reg_bit"]
            + self.muxes_per_tpe * mux
        )

    def _ref_datapath_cost_units(self) -> float:
        r = STAConfig(A=REF["A"], B=REF["B"], C=REF["C"], M=REF["M"], N=REF["N"], mode="vdbb")
        return r._datapath_cost_units() * r.M * r.N

    def power_mw(self, fmt: DBBFormat, act_sparsity=0.5) -> float:
        """Total power for a model with weight format fmt.

        ``act_sparsity``: scalar or a measured ``ActStats`` (per-layer
        zero fraction of the activations actually streamed; DESIGN.md §7).
        """
        act_sparsity = _act_frac(act_sparsity)
        t = TECH[self.tech]
        s = self.speedup(fmt)
        # STA power scales with datapath cost; act-CG gates the gateable
        # fraction proportionally to activation sparsity.
        gate = 1.0
        if self.act_cg:
            base = STA_UNGATEABLE_FRAC + (1 - STA_UNGATEABLE_FRAC) * (1 - act_sparsity)
            ref = STA_UNGATEABLE_FRAC + (1 - STA_UNGATEABLE_FRAC) * (1 - REF["ref_act_sparsity"])
            gate = base / ref
        sta = REF["sta_mw"] * gate * (
            self._datapath_cost_units() * self.M * self.N / self._ref_datapath_cost_units()
        )
        # Weight stream: constant per cycle (compressed stream, the VDBB
        # invariant). Dense/fixed designs read proportionally more bits.
        wsram = REF["wsram_mw"]
        if self.mode == "dense":
            wsram = REF["wsram_mw"] * (8.0 / 3.0)  # uncompressed vs 3/8 ref stream
        # Activation stream scales with speedup (blocks retire faster).
        asram_ref = REF["asram_mw"] if self.im2col else REF["asram_mw_noim2c"]
        asram = asram_ref * (s / REF["ref_speedup"])
        im2c = (REF["im2col_mw"] * (s / REF["ref_speedup"])) if self.im2col else 0.0
        mcu = REF["mcu_mw_each"] * self._n_mcu()
        return (sta + wsram + asram + im2c + mcu) * t["energy_scale"] * (
            t["freq_ghz"] / TECH["16nm"]["freq_ghz"]
        )

    # ---------------- area ----------------
    def area_mm2(self) -> float:
        t = TECH[self.tech]
        sta = REF["sta_mm2"] * (
            self._datapath_cost_units() * self.M * self.N / self._ref_datapath_cost_units()
        )
        area = (
            sta
            + REF["wsram_mm2"]
            + REF["asram_mm2"]
            + REF["mcu_mm2_each"] * self._n_mcu()
            + (REF["im2col_mm2"] if self.im2col else 0.0)
        )
        return area * t["area_scale"]

    # ---------------- headline metrics ----------------
    def tops_per_w(self, fmt: DBBFormat, act_sparsity=0.5) -> float:
        """Effective TOPS/W; ``act_sparsity`` is a scalar or ``ActStats``."""
        return self.effective_tops(fmt) / (self.power_mw(fmt, act_sparsity) / 1e3)

    def tops_per_mm2(self, fmt: DBBFormat) -> float:
        return self.effective_tops(fmt) / self.area_mm2()


# Paper Table V rows for the proposed design (for assertions in tests/bench).
PAPER_TABLE_V_16NM = {  # weight sparsity -> (TOPS/W, TOPS/mm2)
    0.5: (16.8, 2.13),
    0.625: (21.9, 2.85),
    0.75: (31.3, 4.29),
    0.875: (55.7, 8.52),
}
PAPER_TABLE_V_65NM = {0.75: (2.80, 0.26), 0.625: (1.95, 0.17)}

PARETO_DESIGN = STAConfig(A=4, B=8, C=8, M=4, N=8, mode="vdbb", im2col=True)


def conv_workload(design: STAConfig, costs: dict, fmt: DBBFormat,
                  act_sparsity=None) -> dict:
    """Map one conv layer (``dbb_conv_costs`` dict) onto an STA design point.

    Cycles follow the time-unrolled occupancy (executed MACs over the
    array's MAC-equivalents per cycle); energy is power × time at the
    design's calibrated operating point. The activation stream uses the
    raw-tile bytes when the design has the IM2COL unit and the expanded
    im2col bytes otherwise — the two placements of Fig 8.

    ``act_sparsity``: scalar or measured ``ActStats`` for this layer;
    when None it falls back to the sparsity recorded in ``costs`` (set by
    ``dbb_conv_costs(act=...)``), then to the paper's 0.5 assumption.
    """
    if act_sparsity is None:
        act_sparsity = costs.get("act_sparsity", 0.5)
    act_sparsity = _act_frac(act_sparsity)
    t = TECH[design.tech]
    # plain-GEMM cost dicts (dbb_gemm_costs) have no im2col placement split
    act_bytes = (
        costs.get("act_bytes_raw", costs["act_bytes"])
        if design.im2col
        else costs.get("act_bytes_expanded", costs["act_bytes"])
    )
    wbytes = costs["weight_bytes"] if design.mode != "dense" else costs["dense_weight_bytes"]
    # the §9 epilogue placement recorded in the cost dict: a fused epilogue
    # flushes at the next layer's operand width with zero standalone
    # passes; unfused charges the dequant/bias/ReLU/requant round trips.
    obytes = costs.get("out_bytes", 0)
    epi_bytes = costs.get("epilogue_bytes", 0)
    # mode-aware occupancy: a dense SA runs all dense MACs; fixed DBB is
    # capped at its design point; only VDBB tracks the model's nnz/bz
    # (same dispatch as speedup()/effective_tops()).
    cycles = costs["dense_macs"] / max(design.total_macs * design.speedup(fmt), 1)
    time_s = cycles / (t["freq_ghz"] * 1e9)
    power_w = design.power_mw(fmt, act_sparsity) / 1e3
    return dict(
        cycles=cycles,
        time_s=time_s,
        energy_j=power_w * time_s,
        act_bytes=int(act_bytes),
        weight_bytes=int(wbytes),
        out_bytes=int(obytes),
        epilogue_bytes=int(epi_bytes),
        epilogue_fused=bool(costs.get("epilogue_fused", False)),
        hbm_bytes_total=int(act_bytes + wbytes + obytes + epi_bytes),
        sram_reads_saved=costs.get("im2col_magnification", 1.0) if design.im2col else 1.0,
        effective_tops=costs["effective_ops"] / max(time_s, 1e-30) / 1e12,
        act_sparsity=act_sparsity,
        effective_ops=costs["effective_ops"],
    )


def model_workload(design: STAConfig, layers) -> dict:
    """Compose per-layer workloads over a whole model (DESIGN.md §7).

    ``layers``: iterable of (costs, fmt, act_sparsity) triples — one per
    GEMM/conv layer, where ``costs`` is a ``dbb_gemm_costs``/
    ``dbb_conv_costs`` dict and ``act_sparsity`` is that layer's measured
    ``ActStats`` (or a scalar, or None to use what ``costs`` recorded).

    Returns whole-model totals: energy/time sums, effective TOPS/W from
    the summed effective ops over the summed energy (the honest Fig 12
    composition — each layer runs at its *own* measured activation
    sparsity), plus the executed-MAC-weighted mean activation sparsity.
    """
    layers = list(layers)
    per_layer = [conv_workload(design, c, f, a) for c, f, a in layers]
    if not per_layer:
        raise ValueError("model_workload() of empty layer list")
    time_s = sum(w["time_s"] for w in per_layer)
    energy = sum(w["energy_j"] for w in per_layer)
    eff_ops = sum(w["effective_ops"] for w in per_layer)
    weights = [c["executed_macs"] for c, _, _ in layers]
    wsum = float(sum(weights)) or 1.0
    mean_act = sum(w["act_sparsity"] * m for w, m in zip(per_layer, weights)) / wsum
    return dict(
        layers=per_layer,
        time_s=time_s,
        energy_j=energy,
        effective_tops=eff_ops / max(time_s, 1e-30) / 1e12,
        tops_per_w=eff_ops / 1e12 / max(energy, 1e-30),
        mean_act_sparsity=mean_act,
    )


def fmt_for_sparsity(sparsity: float, bz: int = 8) -> DBBFormat:
    nnz = round((1.0 - sparsity) * bz)
    return DBBFormat(bz=bz, nnz=max(1, min(bz, nnz)))
