"""Fused IM2COL convolution, dense weights (port of
``repro/kernels/im2col_conv.py``): the CUDA kernel ``csrc/im2col_conv.cu``
and its plain PyTorch version. NHWC input, HWIO weight; the optional
epilogue fuses bias, ReLU and the requantize to int8, so the fp32 stem of the
int8-resident chain is one kernel.

The kernel has two paths, chosen by shape in :func:`conv_path`: a direct
conv (fp32, when a block's input halo and weight slice fit
``DIRECT_SMEM_BYTES`` of shared memory; the C = 3 stem) and an implicit GEMM
on ``csrc/os_gemm.cuh`` (int8, and fp32 at larger C)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P
from repro_torch.kernels.core import (_pair, acc_dtype_for, apply_epilogue, conv_geometry,
                                      epilogue_plan)
from repro_torch.kernels.ref import acc_matmul, im2col_explicit

KERNEL = build.CudaKernel(
    "im2col_conv", "im2col_conv.cu",
    [P, P, P, P, P, I, P, I, I] + [I] * 14 + [P],
    replaces="src/repro/kernels/im2col_conv.py:73 _im2col_conv_kernel",
)

# csrc/im2col_conv.cu, namespace direct_conv: a block's output tile (rows,
# columns), its floats per weight row (64 filters in groups of 8, each
# padded to 12), and the shared memory the wrapper lets its halo and weight
# slice take
DIRECT_TILE = (4, 32)
DIRECT_WROW = 96
DIRECT_SMEM_BYTES = 48 * 1024


def direct_smem_bytes(c: int, kh: int, kw: int, stride) -> int:
    """Shared memory of a direct-conv block: the fp32 input halo of its
    output tile (rounded up to 4 floats) and its weight slice, as the kernel
    sizes them (``HaloTile::smem_bytes``)."""
    (sh, sw), (th, tw) = _pair(stride), DIRECT_TILE
    halo = ((th - 1) * sh + kh) * ((tw - 1) * sw + kw) * c
    return 4 * (-(-halo // 4) * 4 + kh * kw * c * DIRECT_WROW)


def conv_path(dtype: torch.dtype, c: int, kh: int, kw: int, stride) -> str:
    """'direct' for fp32 operands whose block halo and weight slice fit
    ``DIRECT_SMEM_BYTES`` (the C = 3 stem at stride 1 or 2 takes 13 or 16
    KB), else 'gemm': int8 operands, and fp32 at a C too large for the
    budget (C = 16 at 3x3 needs 67 KB)."""
    if dtype == torch.float32 and direct_smem_bytes(c, kh, kw, stride) <= DIRECT_SMEM_BYTES:
        return "direct"
    return "gemm"


def _geometry(x_shape, w, stride, padding):
    n, h, wd, c = x_shape
    kh, kw, wc, f = w.shape
    if wc != c:
        raise ValueError(f"channel mismatch: x has {c}, w has {wc}")
    return conv_geometry(h, wd, kh, kw, stride, padding)


def _plan(x, w, stride, padding, scales, bias, relu, out_scale):
    ep = epilogue_plan(w.shape[-1], x.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(x.dtype))
    return _geometry(x.shape, w, stride, padding), ep


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
    the kernel, on the path :func:`conv_path` picks for the shape."""
    if x.device.type == "cpu":
        return im2col_conv_plain(x, w, scales=scales, bias=bias, relu=relu,
                                 out_scale=out_scale, stride=stride, padding=padding)
    geom, ep = _plan(x, w, stride, padding, scales, bias, relu, out_scale)
    return _launch(x, w, geom, ep)


def _launch(x, w, geom, ep):
    """The kernel on CUDA operands, the conv geometry and the flush resolved."""
    (sh, sw), (ph, pw), (ho, wo) = geom
    if w.dtype != x.dtype:
        raise TypeError(f"im2col_conv: x is {x.dtype}, w is {w.dtype}")
    in_kind = build.check_operands("im2col_conv", x, w, dtype=x.dtype)
    n, h, wd, c = x.shape
    kh, kw, _, f = w.shape
    direct = conv_path(x.dtype, c, kh, kw, (sh, sw)) == "direct"
    out = torch.empty((n, ho, wo, f), dtype=ep.out_dtype, device=x.device)
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), build.pointer(ep.scale), build.pointer(ep.bias),
        build.pointer(ep.out_scale), int(ep.relu), out.data_ptr(), in_kind,
        build.out_kind(ep.out_dtype), n, h, wd, c, f, ho, wo, kh, kw, sh, sw,
        ph[0], pw[0], int(direct), build.stream_of(x),
    )
    return out


def stage_im2col_conv(w, x_shape, *, scales=None, bias=None, relu=False, out_scale=None,
                      stride=1, padding="SAME"):
    """:func:`im2col_conv` with the weight's side resolved once, for a plan
    (``models/plan.py``): the flush rows, and the path :func:`conv_path`
    takes at ``x_shape``. Returns ``(run, tiles)``: ``run(x)`` is the conv
    (the plain version for a CPU tensor, the kernel for a CUDA one), and
    ``tiles`` records the path."""
    kh, kw, c, f = w.shape
    _geometry(x_shape, w, stride, padding)
    ep = epilogue_plan(f, w.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(w.dtype))

    def run(x):
        if x.device.type == "cpu":
            return im2col_conv_plain(x, w, **ep.flush_kw, stride=stride, padding=padding)
        return _launch(x, w, _geometry(x.shape, w, stride, padding), ep)

    return run, {"path": conv_path(w.dtype, c, kh, kw, stride)}
