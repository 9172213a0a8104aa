"""The program's spans as the benchmark reads them (``lib/spans.py``,
``tools/spans.py``): each span's seconds, count and idle seconds on
hand-made events, and the tool's traced row of each cell on the CPU."""
import math

import pytest
import torch

from portbench.lib import harness, spans, trace
from portbench.tests.helpers import SMALL
from portbench.tools import spans as tool

US = 1000


def _events():
    w = [(False, "user_annotation", trace.WINDOW, 0, 100 * US)]
    host = [(False, "user_annotation", "portbench.generate", 0, 100 * US),
            (False, "user_annotation", "repro_torch.generate.capture", 0, 40 * US),
            (False, "user_annotation", "repro_torch.capture", 5 * US, 35 * US),
            (False, "user_annotation", "repro_torch.generate.capture", 50 * US, 60 * US),
            (False, "user_annotation", "repro_torch.generate.decode", 60 * US, 130 * US),
            (False, "cpu_op", "aten::mean", 10 * US, 20 * US)]
    dev = [(True, "kernel", "k", 10 * US, 30 * US),
           (True, "kernel", "k", 70 * US, 80 * US),
           (True, "gpu_memcpy", "Memcpy DtoD", 75 * US, 90 * US),
           (True, "gpu_user_annotation", "repro_torch.generate.decode", 70 * US, 90 * US),
           (True, "gpu_user_annotation", "portbench.generate", 10 * US, 90 * US)]
    return w + host + dev


def test_each_span_reduced_to_seconds_count_and_idle_within_the_window():
    ev = _events()
    w0, w1, busy = tool.window_and_busy(ev)
    assert (w0, w1) == (0, 100 * US)
    assert busy == [[10 * US, 30 * US], [70 * US, 90 * US]]  # annotations left out by name
    red = spans.reduce(ev, w0, w1, busy)
    assert set(red) == {"repro_torch.generate.capture", "repro_torch.capture",
                        "repro_torch.generate.decode"}
    cap = red["repro_torch.generate.capture"]
    assert cap["count"] == 2
    assert cap["seconds"] == pytest.approx(50e-6)  # [0, 40) and [50, 60)
    assert cap["idle_seconds"] == pytest.approx(30e-6)  # less [10, 30)
    dec = red["repro_torch.generate.decode"]  # clipped to the window: [60, 100)
    assert dec["seconds"] == pytest.approx(40e-6) and dec["idle_seconds"] == pytest.approx(20e-6)
    assert red["repro_torch.capture"]["idle_seconds"] == pytest.approx(10e-6)
    assert tool.covered(ev, "portbench.generate") == pytest.approx(0.9)  # all but [40, 50)
    assert math.isnan(tool.covered(ev, "portbench.request"))


def test_the_program_spans_move_no_reading_of_the_harness_and_name_its_gaps():
    ev = _events()
    with_spans = trace.reduce_events(ev, 1.0)
    plain = trace.reduce_events([e for e in ev if not e[2].startswith(spans.PREFIX)], 1.0)
    for key in ("window_s", "busy_s", "kernels"):
        assert with_spans[key] == plain[key]
    assert sorted(s for _, s in with_spans["gaps"]) == sorted(s for _, s in plain["gaps"])
    assert {n for n, _ in plain["gaps"]} == {"portbench.generate"}
    assert dict(with_spans["gaps"]) == {"repro_torch.generate.capture": pytest.approx(40e-6),
                                        "repro_torch.capture": pytest.approx(10e-6),
                                        "repro_torch.generate.decode": pytest.approx(10e-6)}


def _row(workload, untraced_s=0.0):
    cell = harness.resolve(workload)
    ctx = harness.Context(cell, dict(cell.config, **SMALL[cell.entry["config"]]), 2**31 + 3,
                          torch.device("cpu"))
    return tool.traced_row(ctx, untraced_s)


def test_the_decode_cells_row_on_the_cpu():
    row = _row("starcoder2-7b.decode-b16", 0.1)
    red = row["spans"]
    calls = row["traced_attempted"] // 16
    assert calls >= 1
    assert {n: v["count"] for n, v in red.items()} == {
        "repro_torch.generate." + n: calls * (2 if n == "capture" else 1)
        for n in ("capture", "timing_prefill", "prefill", "reset", "decode", "release")}
    assert all(v["idle_seconds"] == v["seconds"] for v in red.values())  # no card
    assert all(0 < s <= 100 for s in row["shares_of_window"].values())
    assert row["covered"]["portbench.generate"] > 0.9
    assert row["program_ops_on_device"] == [] and row["device_annotations"] == []
    assert row["untraced_e2e"]["gen_tokens_per_s"] > 0


def test_the_prefill_cells_row_on_the_cpu_has_no_plan_span():
    row = _row("starcoder2-7b.prefill-int8")
    assert row["spans"] == {} and row["covered"]["portbench.request"] == 0
    assert row["traced_attempted"] >= 1 and "untraced_e2e" not in row


def test_the_cost_of_a_span_reads_on_the_cpu():
    c = tool.cost(torch.device("cpu"))
    assert c["device"] == "cpu" and c["activities"] == 1
    assert math.isfinite(c["ns_per_span_off"]) and math.isfinite(c["ns_per_span_recording"])
