"""The yardstick's arithmetic: rates over the whole window, tails over all
requests, roofline counts on hand-checked shapes, the trace's reduction and
the readers on synthetic runs."""
import json
import math
import types
from pathlib import Path

import pytest

from portbench.lib import harness, peaks, stats, trace, work

ROOT = Path(__file__).resolve().parents[2]
LM = json.loads((ROOT / "portbench/configs/starcoder2-7b.json").read_text())


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(6400, 2.0) == 3200.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_request_by_nearest_rank():
    values = list(range(1, 101))
    assert stats.quantile(values, 0.95) == 95
    assert stats.quantile(values, 0.5) == 50
    assert stats.quantile([7.0], 0.95) == 7.0
    assert stats.quantile(list(reversed(values)), 0.99) == 99


def test_lm_projection_work_by_hand():
    w = {x["name"]: x for x in work.lm_projection_work(LM, 16, "bf16")}
    assert len(w) == 32 * 6
    wq = w["0.wq"]  # 4608 -> 4608, kept K 1728
    assert wq["ops"] == 2 * 16 * 1728 * 4608
    assert wq["bytes"] == 16 * 4608 * 2 + 1728 * 4608 * 2 + 1728 + 2 * 16 * 4608
    down = {x["name"]: x for x in work.lm_projection_work(LM, 1024, "int8")}["31.w_down"]
    assert down["bytes"] == 1024 * 18432 + 6912 * 4608 + 6912 + 2 * 1024 * 4608 + 4 * 4608
    # one decode step moves about 6 GB: the compressed weights and the dense head
    step = work.lm_decode_step_bytes(LM, 16, 256.5)
    assert 5.6e9 < step < 6.2e9


def test_attention_ops_count_the_pairs_the_mask_keeps():
    assert work.lm_attention_ops(LM, 1, 4, 2.5) == 32 * 4 * 36 * 128 * 4 * 2.5


def test_roofline_takes_the_larger_bound():
    assert peaks.least_seconds(1979e12, 0, "int8") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(989e12, 6.7e12, "bf16") == pytest.approx(2.0)


def _events():
    us = 1000
    w = [(False, "user_annotation", trace.WINDOW, 0, 100 * us)]
    host = [(False, "user_annotation", "portbench.request", 0, 50 * us),
            (False, "cpu_op", "aten::copy_", 10 * us, 30 * us),
            (False, "user_annotation", "portbench.request", 50 * us, 100 * us)]
    dev = [(True, "kernel", "os_mma::kernel<TapMux>", 30 * us, 40 * us),
           (True, "kernel", "os_mma::kernel<TapMux>", 35 * us, 45 * us),
           (True, "gpu_memcpy", "Memcpy HtoD", 60 * us, 70 * us),
           (True, "gpu_user_annotation", "x", 0, 100 * us)]
    return w + host + dev


def test_trace_reduction_busy_union_and_named_gaps():
    s = trace.reduce_events(_events(), 0.5)
    assert s["window_s"] == pytest.approx(100e-6)  # the window span's own clock
    assert s["busy_s"] == pytest.approx(25e-6)  # [30, 45) and [60, 70)
    assert s["kernels"]["os_mma::kernel<TapMux>"] == [pytest.approx(20e-6), 2]
    gaps = dict()
    for name, sec in s["gaps"]:
        gaps[name] = gaps.get(name, 0) + sec
    assert gaps["aten::copy_"] == pytest.approx(30e-6)  # [0, 30): the copy at its midpoint
    assert gaps["portbench.request"] == pytest.approx(45e-6)  # [45, 60) and [70, 100)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "os_mma::kernel<TapMux>"
    assert b["idle_gaps"][0] == ["portbench.request", pytest.approx(45e-6)]
    assert trace.device_seconds(s, ("os_mma", "TapMux")) == (pytest.approx(20e-6), 2)
    assert trace.device_seconds(s, ("bf16_mma",)) == (0.0, 0)


def _ctx(workload, rec, summary):
    cell = harness.resolve(workload)
    return types.SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                                 rec=rec, trace=summary)


@pytest.mark.parametrize("workload,metric", [("starcoder2-7b.decode-b16", "device_idle.decode"),
                                             ("starcoder2-7b.prefill-int8", "device_idle.prefill")])
def test_idle_share_is_the_window_less_the_busy_union(workload, metric):
    ctx = _ctx(workload, {"requests": 10, "window_s": 1.0},
               {"busy_s": 0.9, "window_s": 1.0, "kernels": {}})
    assert ctx.cell.reader(metric).read(ctx) == pytest.approx(10.0)


def test_a_roofline_whose_kernels_did_not_run_reads_nothing():
    ctx = _ctx("starcoder2-7b.prefill-int8", {"requests": 10, "window_s": 1.0},
               {"busy_s": 0.9, "window_s": 1.0, "kernels": {"other": [0.6, 1]}})
    assert ctx.cell.reader("int8_matmul_roofline").read(ctx) is None  # never 0


def test_generate_overhead_and_decode_shares():
    calls = [{"prefill_ms": 100.0, "ms_per_step": 12.0, "wall_s": 4.0,
              "forwards": {"prefill": 5, "decode": 257}, "captures": 2}]
    ctx = _ctx("starcoder2-7b.decode-b16", {"calls": calls, "window_s": 4.0},
               {"busy_s": 3.0, "window_s": 4.0,
                "kernels": {"void bf16_mma::kernel<16, 128, 16, __nv_bfloat16, "
                            "bf16_mma::WordGather>(...)": [1.0, 256 * 192]}})
    r = ctx.cell.reader
    assert r("generate_overhead.decode").read(ctx) == pytest.approx(
        100 * (1 - (100 + 255 * 12) / 4000))
    roof = r("decode_step_roofline").read(ctx)
    assert roof == pytest.approx(
        100 * work.lm_decode_step_bytes(LM, 16, 128 + 1 + 127) / 3.35e12 / 0.012)
    least = sum(peaks.least_seconds(w["ops"], w["bytes"], "bf16")
                for w in work.lm_projection_work(LM, 16, "bf16"))
    assert r("bf16_matmul_roofline").read(ctx) == pytest.approx(100 * least * 256 / 1.0)
    assert 0 < r("decode_mfu").read(ctx) < 1


def test_shares_stay_under_the_peak_on_a_card_paced_run():
    # a window exactly at the roofline reads 100 %, never more
    ctx = _ctx("starcoder2-7b.prefill-int8", {"requests": 10, "window_s": 1.0},
               {"busy_s": 1.0, "window_s": 1.0, "kernels": {}})
    least = sum(peaks.least_seconds(w["ops"], w["bytes"], "int8")
                for w in work.lm_projection_work(LM, 1024, "int8"))
    ctx.trace["kernels"] = {"os_mma::kernel<GatherMux>": [least * 10, 10]}
    assert ctx.cell.reader("int8_matmul_roofline").read(ctx) == pytest.approx(100.0)
    assert math.isfinite(ctx.cell.reader("prefill_mfu").read(ctx))


class _OldEvent:
    """A profiler event as torch 2.11 gives it: no ``activity_type``."""

    def __init__(self, dev, name, start, dur, annotation=False):
        import torch

        self._dev = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU
        self._name, self._start, self._dur, self._ann = name, start, dur, annotation

    def device_type(self):
        return self._dev

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._ann


def test_events_without_an_activity_type_keep_annotations_off_the_device_time():
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: [_OldEvent(False, trace.WINDOW, 0, 1000, True),
                        _OldEvent(True, "portbench.request", 0, 1000, True),
                        _OldEvent(True, "some_kernel", 100, 200)])))
    s = trace.reduce_events(trace._events(prof), 1e-6)
    assert s["busy_s"] == pytest.approx(200e-9)
    assert list(s["kernels"]) == ["some_kernel"]
