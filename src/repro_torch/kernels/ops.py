"""Public entry points of the kernel layer (port of ``repro/kernels/ops.py``).

The same entry points take fp32 or int8 operands. Integer operands run the
exact int32 datapath and return the raw accumulator; the quantized entry
points (:func:`quant_matmul`, :func:`quant_conv`) quantize an fp input per
tensor, or take the previous layer's int8 codes with their scale, and fuse
the dequantization into the flush. Every entry point takes ``bias=``,
``relu=`` and ``out_scale=`` (requantize to int8 at the next layer's scale).

Dispatch follows the weight's pattern sharing: a pattern shared across N
runs the tc kernel, per-column or grouped patterns the bw kernel. Each
wrapper runs its kernel's plain version for CPU tensors.
:func:`sparse_matmul` gates the activations onto a DBB bound first.

The ``stage_*`` entries are the frozen plans' (``models/plan.py``): each
resolves once what its unplanned twin resolves on every call (the dequant
scale product, the shared pattern's index row, the flush rows, the tile
plan with its launch choice: ``choice=``, else the tuned registry's at the
build, else the rule's) and returns ``(run, tiles)``, ``run(x)`` launching
on the resolved operands with that choice frozen in.
"""
from __future__ import annotations

import torch

from repro_torch.core.act_sparsity import act_dbb_prune
from repro_torch.core.quant import QuantDBBWeight, as_f32, resolve_quant_input
from repro_torch.core.vdbb import DBBWeight
from repro_torch.kernels import im2col_conv as _im2col
from repro_torch.kernels import maxpool as _pool
from repro_torch.kernels import vdbb_im2col_conv as _vconv
from repro_torch.kernels import vdbb_matmul as _vm


def _matmul_dispatch(a, w: DBBWeight, scales, *, bias=None, relu=False, out_scale=None,
                     choice=None):
    n = w.shape[1]
    kw = dict(scales=scales, bias=bias, relu=relu, out_scale=out_scale, choice=choice)
    if w.fmt.group_size(n) == n:
        return _vm.vdbb_matmul_tc(a, w.values, w.indices[:, :, 0].contiguous(), w.fmt, **kw)
    return _vm.vdbb_matmul_bw(a, w.values, w.indices, w.fmt, **kw)


def vdbb_matmul(a, w: DBBWeight, *, bias=None, relu=False, out_scale=None, choice=None):
    """A (M, K) @ compressed W (K, N) -> (M, N); int8 operands return the raw
    int32 accumulator unless an epilogue is given. ``choice``: the launch
    choice (``kernels/core.py``), else the tuned registry's or the rule's."""
    return _matmul_dispatch(a, w, None, bias=bias, relu=relu, out_scale=out_scale,
                            choice=choice)


def sparse_matmul(a, w: DBBWeight, *, act_fmt=None, **kw):
    """:func:`vdbb_matmul` with structural activation gating: ``act_fmt``
    (a ``DBBFormat``, typically ``act_sparsity.act_fmt(measure_activation(a))``)
    projects ``a`` onto the block-wise top-|a| constraint, one pattern
    across the M tile, before the kernel; the pruned activations run the
    tc kernel's compressed-K contraction unchanged."""
    if act_fmt is not None:
        a = act_dbb_prune(a, act_fmt)
    return vdbb_matmul(a, w, **kw)


def quant_matmul(x, qw: QuantDBBWeight, act_scale=None, *, bias=None, relu=False,
                 out_scale=None, choice=None):
    """X (M, K) × int8 compressed W -> fp32 (M, N), or int8 with
    ``out_scale``. ``x`` is fp (quantized at ``act_scale``, or dynamically)
    or int8 codes with their ``act_scale``."""
    xq, s_a = resolve_quant_input(x, act_scale)
    return _matmul_dispatch(xq, qw.as_dbb(), s_a * qw.scales, bias=bias,
                            relu=relu, out_scale=out_scale, choice=choice)


def fused_im2col_conv(x, w, *, bias=None, relu=False, out_scale=None, stride=1,
                      padding="SAME", choice=None):
    """Fused im2col conv (NHWC / HWIO), dense weights, optional epilogue."""
    return _im2col.im2col_conv(x, w, bias=bias, relu=relu, out_scale=out_scale,
                               stride=stride, padding=padding, choice=choice)


def sparse_conv(x, w: DBBWeight, kh: int, kw: int, *, bias=None, relu=False,
                out_scale=None, stride=1, padding="SAME", choice=None):
    """Fused IM2COL × VDBB conv over a compressed conv weight."""
    return _vconv.vdbb_im2col_conv(x, w, kh, kw, bias=bias, relu=relu, out_scale=out_scale,
                                   stride=stride, padding=padding, choice=choice)


def quant_conv(x, qw: QuantDBBWeight, kh: int, kw: int, act_scale=None, *,
               bias=None, relu=False, out_scale=None, stride=1, padding="SAME", choice=None,
               residual=None):
    """NHWC × int8 compressed conv weight -> fp32 NHWC, or int8 with
    ``out_scale``; the conv twin of :func:`quant_matmul`. ``residual`` =
    (int8 codes of the output's shape, their scale): a ResNet block's
    shortcut, added in the flush after the bias, before ReLU."""
    xq, s_a = resolve_quant_input(x, act_scale)
    return _vconv.vdbb_im2col_conv(xq, qw.as_dbb(), kh, kw, scales=s_a * qw.scales,
                                   bias=bias, relu=relu, out_scale=out_scale,
                                   stride=stride, padding=padding, choice=choice,
                                   residual=residual)


def maxpool(x, kernel: int, stride: int, padding: int):
    """k x k max-pool of NHWC int8 codes (to codes at the same scale) or
    fp32; padding never wins a window."""
    return _pool.maxpool(x, kernel, stride, padding)


def _calibrated(qw: QuantDBBWeight, act_scale):
    if act_scale is None:
        raise ValueError("a plan stages a calibrated activation scale and this layer has "
                         "none: quantize the model with calibration stats")
    return as_f32(act_scale, qw.device)


def stage_quant_matmul(qw: QuantDBBWeight, act_scale, m: int, *, bias=None, relu=False,
                       out_scale=None, dynamic: bool = False, choice=None):
    """:func:`quant_matmul` at ``m`` rows, staged once: ``run(x)`` quantizes
    an fp ``x`` at the calibrated ``act_scale`` (int8 codes pass as they
    are) and launches with the scale product ``act_scale * qw.scales``.

    With ``dynamic`` and no ``act_scale``, ``run(x)`` quantizes an fp ``x``
    at its own per-tensor scale (``core.quant.dynamic_act_scale``) and
    writes the scale product into the staged flush row on the card before
    the launch (the row is the epilogue's, shared, not copied):
    no host read, so a CUDA graph captures it, and the same bits as the
    unplanned :func:`quant_matmul` with ``act_scale=None``."""
    if act_scale is None and dynamic:
        row = torch.empty(qw.shape[1], dtype=torch.float32, device=qw.device)
        run, tiles = _vm.stage_vdbb_matmul(qw.as_dbb(), m, scales=row, bias=bias, relu=relu,
                                           out_scale=out_scale, choice=choice)

        def run_dynamic(x):
            xq, s_a = resolve_quant_input(x, None)  # int8 codes without a scale raise
            torch.mul(s_a, qw.scales, out=row)
            return run(xq)

        return run_dynamic, tiles
    s_a = _calibrated(qw, act_scale)
    run, tiles = _vm.stage_vdbb_matmul(qw.as_dbb(), m, scales=s_a * qw.scales, bias=bias,
                                       relu=relu, out_scale=out_scale, choice=choice)
    return (lambda x: run(resolve_quant_input(x, s_a)[0])), tiles


def stage_quant_conv(qw: QuantDBBWeight, kh: int, kw: int, act_scale, x_shape, *,
                     bias=None, relu=False, out_scale=None, stride=1, padding="SAME",
                     choice=None, res_scale=None):
    """:func:`quant_conv` at input shape ``x_shape``, staged once; the conv
    twin of :func:`stage_quant_matmul`. With ``res_scale`` the flush takes
    a residual operand at that scale and ``run(x, residual)`` its codes."""
    s_a = _calibrated(qw, act_scale)
    run, tiles = _vconv.stage_vdbb_im2col_conv(
        qw.as_dbb(), kh, kw, x_shape, scales=s_a * qw.scales, bias=bias, relu=relu,
        out_scale=out_scale, stride=stride, padding=padding, choice=choice, res_scale=res_scale)
    return (lambda x, residual=None: run(resolve_quant_input(x, s_a)[0], residual)), tiles


def stage_fused_im2col_conv(w, x_shape, *, bias=None, relu=False, out_scale=None, stride=1,
                            padding="SAME", choice=None):
    """:func:`fused_im2col_conv` at input shape ``x_shape``, staged once."""
    return _im2col.stage_im2col_conv(w, x_shape, bias=bias, relu=relu, out_scale=out_scale,
                                     stride=stride, padding=padding, choice=choice)
