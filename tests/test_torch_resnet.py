"""ResNet v1.5 on the port's CPU path: each new layer against plain PyTorch,
a small ResNet against the benchmark's plain reference
(``portbench/references/resnet.py``, the same file the benchmark compares
with) in float32 and INT8, the INT8 plan against the unplanned INT8 forward,
and the plain layout's state trees unchanged. Imports neither JAX nor the
JAX package; the kernels run their plain versions here (the card's are held
against those in ``tests/test_torch_cuda.py``)."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.cnn import get_cnn_config, smoke_cnn_config
from repro_torch.core import quant as tq
from repro_torch.core import vdbb as tv
from repro_torch.core.sparse_conv import DBBConv2d
from repro_torch.kernels import core as kcore
from repro_torch.kernels import im2col_conv as stem_k
from repro_torch.kernels import maxpool as pool_k
from repro_torch.kernels import ops
from repro_torch.kernels import vdbb_im2col_conv as conv_k
from repro_torch.models.cnn import SparseCNN

ROOT = Path(__file__).resolve().parents[1]
FMT = tv.DBBFormat(8, 3, "matrix")
# float32 against float32 in another summation order (im2col + one product
# against F.conv2d's): sums of at most a few hundred terms of unit size
F32 = dict(rtol=1e-5, atol=1e-5)
# the small ResNet in the benchmark's configuration, as its CPU tests cut it
SMALL = {"image_size": 32, "stem_channels": 8, "stage_channels": [8, 16, 32, 64],
         "blocks_per_stage": [1, 1, 1, 1], "num_classes": 10}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _nchw_conv(x, w, b, stride, pad):
    """F.conv2d on the NHWC / HWIO layouts."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("stride", [1, 2])
def test_one_by_one_conv_against_torch(stride):
    """A compressed 1 x 1 conv (a block's first or last conv at stride 1, a
    projection at stride 2), float32, against F.conv2d on its dense weight;
    and its INT8 path against the exact integer product of the same codes."""
    g = _gen(10 + stride)
    layer = DBBConv2d(16, 24, kernel_size=1, stride=stride, padding=((0, 0), (0, 0)), fmt=FMT,
                      use_bias=True)
    layer.init(g, "cpu")
    layer.put("b", torch.randn(24, generator=g))
    x = torch.randn(3, 9, 9, 16, generator=g)
    dense, b = layer.w.clone(), layer.b
    layer.compress_params()
    torch.testing.assert_close(layer(x), _nchw_conv(x, dense, b, stride, 0), **F32)
    layer.quantize(act_scale=float(x.abs().max()) / 127)
    xq = tq.quantize(x, layer.aq)
    qw = layer.w
    wq = tv.dbb_decode_conv(tv.DBBWeight(qw.values.float(), qw.indices, qw.fmt, qw.shape), 1, 1)
    acc = _nchw_conv(xq.double(), wq.double(), None, stride, 0).float()
    want = acc * (layer.aq * qw.scales) + b
    assert torch.equal(layer.quant_serve(xq), want)


def test_stem_seven_by_seven_stride_two_against_torch():
    """The dense 7 x 7 stride-2 stem with torchvision's pads (3 on each
    side), against F.conv2d, and its output size (224 -> 112)."""
    g = _gen(3)
    stem = DBBConv2d(3, 16, kernel_size=7, stride=2, padding=((3, 3), (3, 3)), use_bias=True)
    stem.init(g, "cpu")
    stem.put("b", torch.randn(16, generator=g))
    x = torch.randn(2, 23, 21, 3, generator=g)
    torch.testing.assert_close(stem(x), _nchw_conv(x, stem.w, stem.b, 2, 3), **F32)
    assert stem.out_hw(224, 224) == (112, 112)


@pytest.mark.parametrize("shape", [(2, 112, 112, 16), (3, 9, 7, 32)])
def test_int8_maxpool_against_torch(shape):
    """The 3 x 3 stride-2 pad-1 max-pool on int8 codes against F.max_pool2d
    (padding never wins), exactly, and pooling codes equals requantizing the
    pooled float32 values (max commutes with the monotone requantize)."""
    g = _gen(sum(shape))
    y = torch.relu(torch.randn(*shape, generator=g))
    codes = tq.quantize(y, 0.02)
    want = F.max_pool2d(codes.permute(0, 3, 1, 2).float(), 3, 2, 1).permute(0, 2, 3, 1)
    got = ops.maxpool(codes, 3, 2, 1)
    assert got.dtype == torch.int8 and torch.equal(got.float(), want)
    assert torch.equal(got, tq.quantize(pool_k.maxpool_plain(y, 3, 2, 1), 0.02))


@pytest.mark.parametrize("relu,out_scale", [(True, 0.05), (True, None), (False, 0.05)])
def test_residual_epilogue_against_plain_steps(relu, out_scale):
    """The residual flush (the tc conv's plain version, the card kernel's
    oracle) against a plain dequantize, bias, residual add, ReLU and
    requantize written out step by step, each rounded once: exactly."""
    g = _gen(5)
    x = torch.randint(-127, 128, (2, 6, 6, 16), generator=g, dtype=torch.int8)
    w = torch.randn(1, 1, 16, 32, generator=g)
    dw = tv.dbb_encode_conv(w, FMT, prune=True)
    qw = tq.quantize_dbb(dw)
    res = torch.randint(-127, 128, (2, 6, 6, 32), generator=g, dtype=torch.int8)
    scale, bias, rs = qw.scales * 0.01, torch.randn(32, generator=g), torch.tensor(0.03)
    got = conv_k.vdbb_im2col_conv(x, qw.as_dbb(), 1, 1, scales=scale, bias=bias, relu=relu,
                                  out_scale=out_scale, padding="VALID", residual=(res, rs))
    wq = tv.dbb_decode_conv(tv.DBBWeight(qw.values.float(), qw.indices, qw.fmt, qw.shape), 1, 1)
    acc = _nchw_conv(x.double(), wq.double(), None, 1, 0).float()
    y = acc * scale
    y = y + bias
    y = y + res.float() * rs
    if relu:
        y = torch.relu(y)
    if out_scale is not None:
        y = torch.round(y / torch.tensor(out_scale)).clamp(-127, 127).to(torch.int8)
    assert got.dtype == y.dtype and torch.equal(got, y)
    with pytest.raises(ValueError, match="scales"):
        kcore.epilogue_plan(32, "cpu", residual=(res, rs), acc_dtype=torch.int32)


def _bench_cfg(blocks=(1, 1, 1, 1)):
    cfg = json.loads((ROOT / "portbench/configs/resnet50-v1.5.json").read_text())
    return dict(cfg, **dict(SMALL, blocks_per_stage=list(blocks)))


def _small_resnet(cfg, seed):
    """The port's SparseCNN holding the benchmark's seeded weights."""
    from portbench.lib.cnn_weights import cnn_conv, cnn_head, cnn_layout

    c = dataclasses.replace(smoke_cnn_config("resnet50-v1.5"),
                            blocks_per_stage=tuple(cfg["blocks_per_stage"]))
    model = SparseCNN(c)
    layout = cnn_layout(cfg)
    tree = {f"l{i}": cnn_conv(cfg, seed, layer, "cpu") for i, layer in enumerate(layout)}
    tree[f"l{len(layout)}"] = cnn_head(cfg, seed, "cpu")
    return model.load_state(tree).compress()


def _against_the_plain_reference(cfg, seed):
    """The port's float32 forward against the reference's float32 one, and
    the port's INT8 chain (calibrated on its own float32 forward) against
    the reference's INT8 path (calibrated on its own)."""
    from portbench.lib.cnn_weights import cnn_images
    from portbench.references import resnet as ref

    model = _small_resnet(cfg, seed)
    x, calib = cnn_images(cfg, seed, "x", 4, "cpu"), cnn_images(cfg, seed, "calib", 8, "cpu")
    with torch.no_grad():
        got = model(x)
        want = ref.forward(cfg, seed, x)
        # float32 through 18 or 21 layers in two summation orders, logits of unit size
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        _, stats = model(calib, collect_act_stats=True)
        model.quantize(stats)
        amax = ref.calibrate(cfg, seed, calib)
        q = model(x)
        # the same codes from the same scales: the calibrations agree here,
        # so the chains agree bit for bit
        assert torch.equal(q, ref.forward(cfg, seed, x, "int8", amax))
        assert not torch.equal(q, ref.forward(cfg, seed, x, "int4", amax))
    return model


@pytest.mark.parametrize("seed", [2**31 + 5, 2**40 + 9])
def test_small_resnet_against_the_plain_reference(seed):
    """widths ÷ 8, one block a stage, 32 x 32 images, on the benchmark's
    seeded weights: every block has a projection shortcut."""
    model = _against_the_plain_reference(_bench_cfg(), seed)
    assert all(b.proj is not None for b in model.blocks)


@pytest.mark.parametrize("seed", [2**31 + 7, 2**40 + 11])
def test_small_resnet_identity_shortcut_against_the_plain_reference(seed):
    """Two blocks in the first stage: the second adds its input's own codes
    (the identity shortcut, read at its first conv's scale, as 12 of
    ResNet-50's 16 blocks do), bit for bit against the reference in INT8."""
    model = _against_the_plain_reference(_bench_cfg((2, 1, 1, 1)), seed)
    assert [b.proj is None for b in model.blocks] == [False, True, False, False, False]


def test_int8_plan_bit_identical_to_unplanned():
    """The smoke ResNet's INT8 plan (stem, four blocks, head) serves what the
    unplanned INT8 forward gives, bit for bit, at a bucket and a ragged
    batch; its stages and their tiles are the blocks'."""
    g = _gen(8)
    model = SparseCNN(smoke_cnn_config("resnet50-v1.5")).init(g, "cpu").compress()
    x = torch.randn(5, 32, 32, 3, generator=g)
    with torch.no_grad():
        _, stats = model(x, collect_act_stats=True)
        model.quantize(stats)
        ps = model.plan_set(buckets=(2, 8), tune="off")
        assert torch.equal(ps.serve(x), model(x))
        assert torch.equal(ps.serve(x[:2]), model(x[:2]))
    plan = ps.plans[8]
    assert [s.name for s in plan.layers] == ["stem", "block1.0", "block2.0", "block3.0",
                                             "block4.0", "head"]
    assert set(plan.tiles["block2.0"]) == {"l5", "l6", "l7", "l8"}


def test_fp32_plan_matches_unplanned():
    """Uncalibrated (float32) state plans the same bottleneck stages, the
    shortcut added by torch before the ReLU: the same logits."""
    g = _gen(9)
    model = SparseCNN(smoke_cnn_config("resnet50-v1.5")).init(g, "cpu").compress()
    x = torch.randn(3, 32, 32, 3, generator=g)
    with torch.no_grad():
        assert torch.equal(model.plan(batch=3, tune="off").serve(x), model(x))


def test_resnet50_layout_at_published_widths():
    """resnet50-v1.5: 53 convs and the head, 16 blocks (3, 4, 6, 3), four
    projections, 25.5 M weights, 224 -> 112 -> 56 -> 28 -> 14 -> 7."""
    model = SparseCNN(get_cnn_config("resnet50-v1.5"))
    assert model.n_layers == 54 and len(model.blocks) == 16
    assert [b.proj is not None for b in model.blocks].count(True) == 4
    assert model.cfg.param_count() == 25_502_912
    ins = model.conv_inputs()
    assert ins[0] == (224, 224) and ins[model.blocks[0].c1] == (56, 56)
    assert [ins[b.c1] for b in model.blocks if b.index == 0] == [(56, 56), (56, 56), (28, 28),
                                                                 (14, 14)]
    assert model.layers()[-1].in_features == 2048
    # v1.5: a downsampling block strides its 3 x 3, not its first 1 x 1
    b = model.blocks[3]
    assert model.layers()[b.c1].stride == (1, 1) and model.layers()[b.c2].stride == (2, 2)


# the plain layout's parameter trees (the JAX reference's keys and shapes)
PLAIN_TREES = {
    "sparse-cnn-tiny": [(3, 3, 3, 32), (3, 3, 32, 32), (3, 3, 32, 64), (3, 3, 64, 64),
                        (3, 3, 64, 128), (3, 3, 128, 128), (128, 10)],
    "sparse-cnn-s": [(3, 3, 3, 64), (3, 3, 64, 64), (3, 3, 64, 128), (3, 3, 128, 128),
                     (3, 3, 128, 256), (3, 3, 256, 256), (3, 3, 256, 512), (3, 3, 512, 512),
                     (512, 1000)],
}


@pytest.mark.parametrize("arch", sorted(PLAIN_TREES))
def test_plain_configs_keep_their_trees(arch):
    """sparse-cnn-tiny and sparse-cnn-s keep their layer keys l0 … lN, their
    weight shapes, SAME padding and their state keys (w, b; aq once
    calibrated; never oq)."""
    model = SparseCNN(get_cnn_config(arch)).init(_gen(1), "cpu")
    tree = model.state()
    shapes = PLAIN_TREES[arch]
    assert list(tree) == [f"l{i}" for i in range(len(shapes))]
    assert [tuple(tree[f"l{i}"]["w"].shape) for i in range(len(shapes))] == shapes
    assert all(set(v) == {"w", "b"} for v in tree.values())
    assert not model.blocks and all(m.padding == "SAME" for m in model.layers()[:-1])
    small = SparseCNN(smoke_cnn_config(arch)).init(_gen(2), "cpu").compress()
    x = torch.randn(2, 16, 16, 3, generator=_gen(3))
    with torch.no_grad():
        _, stats = small(x, collect_act_stats=True)
    assert len(stats) == small.n_layers
    small.quantize(stats)
    assert all(set(v) == {"w", "b", "aq"} for k, v in small.state().items() if k != "l0")


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """Importing the port, building and serving the smoke ResNet loads no
    module of JAX or of the JAX package."""
    code = ("import sys, torch\n"
            "from repro_torch.configs.cnn import smoke_cnn_config\n"
            "from repro_torch.models.cnn import SparseCNN\n"
            "import repro_torch.launch.serve\n"
            "m = SparseCNN(smoke_cnn_config('resnet50-v1.5')).init(torch.Generator(), 'cpu')\n"
            "m(torch.zeros(1, 32, 32, 3))\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_trainer_refuses_a_cnn(capsys):
    """The port's trainer trains the LM registry's archs; a CNN arch (the
    ResNet among them) is refused at the command line with a message that
    says so, before anything is built."""
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(["--arch", "resnet50-v1.5", "--smoke", "--device", "cpu"])
    assert "no CNN trainer" in capsys.readouterr().err
