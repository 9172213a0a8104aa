"""The cell ``resnet50-v1.5.b64-resident`` on the CPU at a small size (its
configuration's widths ÷ 8, one block a stage, 32 x 32 images; the traffic
as the cell has it): a whole run reads ``correct``, a planted fault fails
it, the new readers read nothing without their kernels and the work counts
hold on hand-checked shapes; and, on the card, the reference's INT4 control
fails the cell's limit on three seeds."""
import gc
import json
import time
import types
from pathlib import Path

import pytest
import torch

from portbench.lib import cnn_work, harness, peaks

ROOT = Path(__file__).resolve().parents[2]
CELL = "resnet50-v1.5.b64-resident"
SMALL = {"image_size": 32, "stem_channels": 8, "stage_channels": [8, 16, 32, 64],
         "blocks_per_stage": [1, 1, 1, 1], "num_classes": 10}
CFG = json.loads((ROOT / "portbench/configs/resnet50-v1.5.json").read_text())
READERS = ("cnn_mfu", "conv3x3_roofline", "conv1x1_roofline", "stem_roofline",
           "maxpool_roofline", "device_idle.b64-resident")


def _run(faults=(), trace=False):
    return harness.run_cell(CELL, 2**31 + 29, 0.5, trace, "cpu", t_start=time.time(),
                            overrides=SMALL, faults=faults)


def test_small_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    # the CPU runs the plain versions, whose INT8 chain the reference
    # reproduces exactly at this size
    assert out["checks"]["logit_err"]["value"] < 1e-6
    assert set(out["metrics"]) == {"prefill_ms", "setup_s"}


def _small_loop(seed, device):
    cell = harness.resolve(CELL)
    ctx = harness.Context(cell, dict(cell.config, **SMALL), seed, device)
    loop = cell.loop.Loop(ctx)
    loop.setup()
    ctx.rec = loop.window(0.2, None)
    return loop


def test_the_program_scales_reach_the_reference_by_name():
    """The program's calibrated scales, handed to the reference under its
    names, give the reference's own calibration here (both calibrate on the
    same float32 forward, bit for bit on the CPU): the same answers."""
    loop = _small_loop(2**31 + 31, torch.device("cpu"))
    amax = loop.program_amax()
    ref = loop.ctx.cell.reference
    c, t = loop.ctx.config, loop.ctx.traffic
    want = ref.calibrate(c, loop.ctx.seed, loop._images("calib", t["calib_batches"] * loop.b))
    assert set(amax) == set(want) and len(amax) == 4 * 3 + 4 + 1
    for name, v in want.items():  # a scale of amax / 127 in float32, both sides
        assert torch.tensor(amax[name] / 127, dtype=torch.float32) == \
            torch.tensor(v / 127, dtype=torch.float32), name
    assert loop.check(amax=amax)[0]["value"] < 1e-6


def test_a_planted_fault_makes_the_run_incorrect():
    out = _run(faults=("answer",))
    assert not out["correct"], out["checks"]


def test_traced_small_run_reads_only_what_it_has():
    """On the CPU no kernel of the card runs: the kernel readers read
    nothing, the host-clock share and the idle share read."""
    out = _run(trace=True)
    assert set(out["metrics"]) == {"cnn_mfu", "device_idle.b64-resident"}


def _ctx(kernels, requests=10, window_s=0.1):
    cell = harness.resolve(CELL)
    return types.SimpleNamespace(
        config=CFG, traffic=cell.traffic, rec={"requests": requests, "window_s": window_s},
        trace={"kernels": kernels, "busy_s": 0.09, "window_s": window_s, "gaps": []})


LM_KERNELS = {"void os_mma_sm90::kernel<3, GatherMuxSmem>(...)": [0.5, 10],
              "void bf16_mma::kernel<16, 128, 16, __nv_bfloat16, WordGather>(...)": [0.1, 4]}


@pytest.mark.parametrize("name", [r for r in READERS if "roofline" in r])
def test_kernel_readers_read_none_without_their_kernels(name):
    reader = harness.resolve(CELL).reader(name)
    assert reader.read(_ctx(LM_KERNELS)) is None


def test_kernel_readers_match_their_kernels_only():
    """Each roofline reads its own kernels' time: a 3 x 3 conv (TapMux) is
    not a 1 x 1 (PointMux), plain or residual; the stem's direct conv and
    the max-pool are kernels of their own."""
    names = {
        "conv3x3_roofline": "void os_mma::kernel<128, 8, signed char, TapMux, DenseTile, PlainFlush>(TapMux, DenseTile, int, int, int, signed char*, PlainFlush)",
        "conv1x1_roofline": "void os_mma::kernel<128, 8, signed char, PointMux, DenseTile, ResidualFlush>(PointMux, DenseTile, int, int, int, signed char*, ResidualFlush)",
        "stem_roofline": "void direct_conv::kernel<signed char>(direct_conv::HaloTile, float const*, int, int, signed char*, EpilogueArgs)",
        "maxpool_roofline": "void maxpool::kernel<signed char>(signed char const*, signed char*, maxpool::Geometry)",
    }
    for name, kernel in names.items():
        reader = harness.resolve(CELL).reader(name)
        value = reader.read(_ctx({kernel: [1.0, 10]}))
        assert value is not None and 0 < value < 100, name
        for other, k in names.items():
            if other != name:
                assert reader.read(_ctx({k: [1.0, 10]})) is None, (name, other)


def test_cnn_work_by_hand():
    """ResNet-50 at batch 64: 205.7 G operations a request (190.6 G int8 at
    3/8, the stem's 15.1 G float32), a stage-1 bottleneck's convs counted by
    hand, the max-pool's codes in and out."""
    w = {x["name"]: x for x in cnn_work.conv_work(CFG, 64)}
    assert len(w) == 53
    m = 64 * 56 * 56
    c1 = w["b1.1.c1"]  # 256 -> 64, K_c 96
    assert c1["kind"] == "conv1x1" and c1["ops"] == 2 * m * 96 * 64
    assert c1["bytes"] == m * 256 + 96 * 64 + 96 + m * 64 + 12 * 64
    c3 = w["b1.1.c3"]  # 64 -> 256, K_c 24, the shortcut's codes read
    assert c3["bytes"] == m * 64 + 24 * 256 + 24 + m * 256 + 12 * 256 + m * 256 + 4
    assert w["b1.0.c2"]["kind"] == "conv3x3" and w["b1.0.c2"]["ops"] == 2 * m * 216 * 64
    proj = w["b2.0.proj"]  # 256 -> 512 at stride 2: reads a quarter of its 56 x 56 input
    m2 = 64 * 28 * 28
    assert proj["kind"] == "conv1x1" and proj["ops"] == 2 * m2 * 96 * 512
    assert proj["bytes"] == m2 * 256 + 96 * 512 + 96 + m2 * 512 + 12 * 512
    c2 = w["b2.0.c2"]  # the strided 3 x 3 reads every input pixel
    assert c2["bytes"] == 64 * 56 * 56 * 128 + 432 * 128 + 432 + m2 * 128 + 12 * 128
    assert w["b4.2.c3"]["bytes"] == (64 * 49 * 512 + 192 * 2048 + 192 + 4 * 64 * 49 * 2048
                                     + 12 * 2048 + 64 * 49 * 2048 + 4)
    stem = w["stem"]
    assert stem["kind"] == "stem" and stem["ops"] == 2 * 64 * 112 * 112 * 147 * 64
    assert cnn_work.stem_ops(CFG, 64) == stem["ops"]
    assert cnn_work.int8_ops(CFG, 64) == 190_616_174_592
    assert cnn_work.maxpool_bytes(CFG, 64) == 64 * 64 * (112 * 112 + 56 * 56)
    # a request's least time, 0.32 ms: the stem's float32 is two thirds of it
    least = (cnn_work.int8_ops(CFG, 64) / peaks.INT8_OPS_PER_S
             + cnn_work.stem_ops(CFG, 64) / cnn_work.FP32_OPS_PER_S)
    assert 0.31e-3 < least < 0.33e-3


@pytest.mark.cuda
def test_the_control_fails_the_limit(card):
    """The reference's INT4 path in the program's place fails the cell's
    ``logit_err`` limit on three seeds, at the cell's own size. Card only:
    ``python -m pytest -m cuda portbench/tests/test_portbench_resnet.py``."""
    cell = harness.resolve(CELL)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        ctx = harness.Context(cell, dict(cell.config), seed, card)
        loop = cell.loop.Loop(ctx)
        loop.setup()
        ctx.rec = loop.window(1, None)
        loop.free()
        gc.collect()
        torch.cuda.empty_cache()
        checks = loop.check(control=True)
        assert any(c["value"] > c["limit"] for c in checks), (seed, checks)
        del loop, ctx
        gc.collect()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_the_gap_to_the_reference_is_its_calibration(card):
    """On the card the program's answers sit a few hundredths from the
    reference's INT8 path calibrated on its own float32 forward. Given the
    program's own scales instead, the reference comes nearer by far: the
    gap is the two calibrations' (float32 sums in other orders), not the
    INT8 chain's. Prints both readings. Card only."""
    cell = harness.resolve(CELL)
    for seed in (2**31 + 404, 2**33 + 505):
        ctx = harness.Context(cell, dict(cell.config), seed, card)
        loop = cell.loop.Loop(ctx)
        loop.setup()
        ctx.rec = loop.window(1, None)
        amax = loop.program_amax()
        loop.free()
        gc.collect()
        torch.cuda.empty_cache()
        own = loop.check()[0]["value"]
        same = loop.check(amax=amax)[0]["value"]
        print(f"seed {seed}: logit_err {own:.6g} at the reference's own scales, "
              f"{same:.6g} at the program's")
        assert same < own / 4, (seed, own, same)
        del loop, ctx
        gc.collect()
        torch.cuda.empty_cache()
