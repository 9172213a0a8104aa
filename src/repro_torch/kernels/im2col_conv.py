"""Fused IM2COL convolution, dense weights (port of
``repro/kernels/im2col_conv.py``): the CUDA kernel ``csrc/im2col_conv.cu``
and its plain PyTorch version. NHWC input, HWIO weight; the optional
epilogue fuses bias, ReLU and the requantize to int8, so the fp32 stem of the
int8-resident chain is one kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P
from repro_torch.kernels.core import acc_dtype_for, apply_epilogue, conv_geometry, epilogue_plan
from repro_torch.kernels.ref import acc_matmul, im2col_explicit

KERNEL = build.CudaKernel(
    "im2col_conv", "im2col_conv.cu",
    [P, P, P, P, P, I, P, I, I] + [I] * 13 + [P],
    replaces="src/repro/kernels/im2col_conv.py:73 _im2col_conv_kernel",
)


def _plan(x, w, stride, padding, scales, bias, relu, out_scale):
    n, h, wd, c = x.shape
    kh, kw, wc, f = w.shape
    if wc != c:
        raise ValueError(f"channel mismatch: x has {c}, w has {wc}")
    geom = conv_geometry(h, wd, kh, kw, stride, padding)
    ep = epilogue_plan(f, x.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(x.dtype))
    return geom, ep


def im2col_conv_plain(x, w, *, scales=None, bias=None, relu=False, out_scale=None,
                      stride=1, padding="SAME"):
    """Plain version: explicit im2col, one product, the plain flush."""
    (_, _, (ho, wo)), ep = _plan(x, w, stride, padding, scales, bias, relu, out_scale)
    kh, kw, c, f = w.shape
    cols = im2col_explicit(x, kh, kw, stride=stride, padding=padding)
    acc = acc_matmul(cols.reshape(-1, kh * kw * c), w.reshape(kh * kw * c, f))
    return apply_epilogue(acc, ep).reshape(x.shape[0], ho, wo, f)


def im2col_conv(x, w, *, scales=None, bias=None, relu=False, out_scale=None,
                stride=1, padding="SAME"):
    """Fused im2col conv. x: (N, H, W, C); w: (kh, kw, C, F), same dtype
    (int8 or fp32). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if x.device.type == "cpu":
        return im2col_conv_plain(x, w, scales=scales, bias=bias, relu=relu,
                                 out_scale=out_scale, stride=stride, padding=padding)
    ((sh, sw), (ph, pw), (ho, wo)), ep = _plan(
        x, w, stride, padding, scales, bias, relu, out_scale)
    if w.dtype != x.dtype:
        raise TypeError(f"im2col_conv: x is {x.dtype}, w is {w.dtype}")
    in_kind = build.check_operands("im2col_conv", x, w, dtype=x.dtype)
    n, h, wd, c = x.shape
    kh, kw, _, f = w.shape
    out = torch.empty((n, ho, wo, f), dtype=ep.out_dtype, device=x.device)
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), build.pointer(ep.scale), build.pointer(ep.bias),
        build.pointer(ep.out_scale), int(ep.relu), out.data_ptr(), in_kind,
        build.out_kind(ep.out_dtype), n, h, wd, c, f, ho, wo, kh, kw, sh, sw,
        ph[0], pw[0], build.stream_of(x),
    )
    return out
