"""Fused IM2COL × VDBB sparse convolution (port of
``repro/kernels/vdbb_im2col_conv.py``): the CUDA kernels
``csrc/vdbb_conv_tc.cu`` for a pattern shared across F (tc mode) and
``csrc/vdbb_conv_bw.cu`` for a pattern per output channel or per group of
channels (bw mode), each beside its plain PyTorch version.

The conv weight (kh, kw, C, F) is compressed along K = kh·kw·C with
C % bz == 0, so every block lies inside one tap; block ``b = t·cb + c//bz``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.vdbb import DBBFormat, DBBWeight, gather_compressed
from repro_torch.kernels import build
from repro_torch.kernels.build import I, P
from repro_torch.kernels.core import (KIND_CONV_BW, KIND_CONV_TC, acc_dtype_for, apply_epilogue,
                                      check_indices, conv_geometry, conv_sig, epilogue_plan,
                                      mma_plan, mma_tap_plan)
from repro_torch.kernels.ref import acc_matmul, decode_values, im2col_explicit

KERNEL = build.CudaKernel(
    "vdbb_conv_tc", "vdbb_conv_tc.cu",
    [P, P, P, P, P, P, I, P, I, I] + [I] * 16 + [P],
    replaces="src/repro/kernels/vdbb_im2col_conv.py:60 _vdbb_conv_tc_kernel",
)

BW_KERNEL = build.CudaKernel(
    "vdbb_conv_bw", "vdbb_conv_bw.cu",
    [P, P, P, P, P, P, I, P, I, I] + [I] * 17 + [P],
    replaces="src/repro/kernels/vdbb_im2col_conv.py:95 _vdbb_conv_bw_kernel",
)


def _conv_weight_geometry(k: int, fmt: DBBFormat, kh: int, kw: int) -> int:
    """C of a compressed conv weight with K = kh·kw·C, checking C % bz == 0."""
    if k % (kh * kw) != 0:
        raise ValueError(f"K={k} not divisible by kh*kw={kh * kw}")
    c = k // (kh * kw)
    if c % fmt.bz != 0:
        raise ValueError(
            f"C={c} not divisible by bz={fmt.bz}: a DBB block would straddle "
            "kernel taps, which the fused conv kernel does not support"
        )
    return c


def _geometry(x_shape, values, indices, fmt, kh, kw, stride, padding):
    nb, nnz, f = values.shape
    if nnz != fmt.nnz:
        raise ValueError(f"values nnz={nnz} != fmt.nnz={fmt.nnz}")
    check_indices(indices, nb, nnz, f, fmt.group_size(f))
    c = _conv_weight_geometry(nb * fmt.bz, fmt, kh, kw)
    if x_shape[-1] != c:
        raise ValueError(f"x has C={x_shape[-1]} but weight encodes C={c}")
    return conv_geometry(x_shape[1], x_shape[2], kh, kw, stride, padding)


def tile_key(tc: bool, x_shape, f: int, fmt, kh: int, kw: int, geom, dtype) -> tuple:
    """The tuned registry's (kind, signature) of a conv launch."""
    (sh, sw), _, (ho, wo) = geom
    n, _, _, c = x_shape
    return ((KIND_CONV_TC if tc else KIND_CONV_BW),
            conv_sig(n, ho, wo, c, f, kh, kw, sh, sw, fmt.bz, fmt.nnz, dtype))


def _mma(tc: bool, x_shape, values, fmt, kh, kw, geom, ptr, choice=None):
    """The int8 tile plan of a conv launch (None for fp32 operands: the
    CUDA-core loop takes no choice): its tile rows ``choice``'s (a plan's),
    else the registry's for the launch, else the rule's. Raises on what the
    int8 kernel does not take."""
    if values.dtype != torch.int8:
        return None
    (_, _, (ho, wo)) = geom
    n, _, w, c = x_shape
    key = tile_key(tc, x_shape, values.shape[-1], fmt, kh, kw, geom, values.dtype)
    if tc:
        kc = values.shape[0] * values.shape[1]
        return mma_tap_plan("vdbb_conv_tc", n * ho * wo, kc, kh, kw, w, c, key=key,
                            choice=choice)
    return mma_plan("vdbb_conv_bw", n * ho * wo, kh * kw * c, c, ptr, key=key, choice=choice)


def _rows(plan) -> int:
    return 0 if plan is None else plan.tile_rows


def _plan(x, values, indices, fmt, kh, kw, stride, padding, scales, bias, relu, out_scale):
    geom = _geometry(x.shape, values, indices, fmt, kh, kw, stride, padding)
    ep = epilogue_plan(values.shape[-1], x.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(x.dtype))
    return geom, ep


def vdbb_im2col_conv_tc_plain(x, values, indices, fmt, kh, kw, *, scales=None,
                              bias=None, relu=False, out_scale=None, stride=1,
                              padding="SAME"):
    """Plain version: explicit im2col, the activation mux through the shared
    pattern, one product over the compressed K, the plain flush."""
    (_, _, (ho, wo)), ep = _plan(x, values, indices, fmt, kh, kw, stride, padding,
                                 scales, bias, relu, out_scale)
    nb, nnz, f = values.shape
    cols = im2col_explicit(x, kh, kw, stride=stride, padding=padding)
    ac = gather_compressed(cols.reshape(-1, nb * fmt.bz), indices, fmt.bz)
    acc = acc_matmul(ac, values.reshape(nb * nnz, f))
    return apply_epilogue(acc, ep).reshape(x.shape[0], ho, wo, f)


def vdbb_im2col_conv_tc(x, values, indices, fmt, kh, kw, *, scales=None,
                        bias=None, relu=False, out_scale=None, stride=1,
                        padding="SAME", choice=None):
    """Fused sparse conv, one pattern shared across F. x: (N, H, W, C) int8
    or fp32; values: (nb, nnz, F) of the same dtype; indices: (nb, nnz) int8
    with nb = kh·kw·C/bz. int8 accumulates exactly in int32 on the tensor
    cores and needs the compressed K = nb·nnz within ``core.MMA_MAX_K`` and
    taps the gather can encode (:func:`core.mma_tap_plan`). ``choice``: the
    int8 tile rows (``{"tile_rows": r}``), else the tuned registry's, else
    the rule's. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return vdbb_im2col_conv_tc_plain(
            x, values, indices, fmt, kh, kw, scales=scales, bias=bias, relu=relu,
            out_scale=out_scale, stride=stride, padding=padding)
    geom, ep = _plan(x, values, indices, fmt, kh, kw, stride, padding, scales, bias, relu,
                     out_scale)
    return _launch_tc(x, values, indices, fmt, kh, kw, geom, ep, choice)


def _launch_tc(x, values, indices, fmt, kh, kw, geom, ep, choice=None):
    """The tc kernel on CUDA operands, the conv geometry and the flush
    resolved; ``choice`` a plan's launch choice, else the registry's or the
    rule's."""
    (sh, sw), (ph, pw), (ho, wo) = geom
    if values.dtype != x.dtype or indices.dtype != torch.int8 or indices.dim() != 2:
        raise TypeError("vdbb_conv_tc: values must match x's dtype, indices be (nb, nnz) int8")
    n, h, w, c = x.shape
    f = values.shape[-1]
    rows = _rows(_mma(True, x.shape, values, fmt, kh, kw, geom, 0, choice))
    in_kind = build.check_operands("vdbb_conv_tc", x, values, indices, dtype=x.dtype)
    out = torch.empty((n, ho, wo, f), dtype=ep.out_dtype, device=x.device)
    KERNEL.launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), build.pointer(ep.scale),
        build.pointer(ep.bias), build.pointer(ep.out_scale), int(ep.relu),
        out.data_ptr(), in_kind, build.out_kind(ep.out_dtype), n, h, w, c, f,
        ho, wo, kh, kw, sh, sw, ph[0], pw[0], fmt.bz, fmt.nnz, rows, build.stream_of(x),
    )
    return out


def vdbb_im2col_conv_bw_plain(x, values, indices, fmt, kh, kw, *, scales=None,
                              bias=None, relu=False, out_scale=None, stride=1,
                              padding="SAME"):
    """Plain version of the per-column (bw) conv: explicit im2col, the
    expanded dense weight, one product over the dense K, the plain flush."""
    (_, _, (ho, wo)), ep = _plan(x, values, indices, fmt, kh, kw, stride, padding,
                                 scales, bias, relu, out_scale)
    nb, nnz, f = values.shape
    cols = im2col_explicit(x, kh, kw, stride=stride, padding=padding)
    acc = acc_matmul(cols.reshape(-1, nb * fmt.bz), decode_values(values, indices, fmt))
    return apply_epilogue(acc, ep).reshape(x.shape[0], ho, wo, f)


def vdbb_im2col_conv_bw(x, values, indices, fmt, kh, kw, *, scales=None,
                        bias=None, relu=False, out_scale=None, stride=1,
                        padding="SAME", choice=None):
    """Fused sparse conv with a pattern per output channel. x: (N, H, W, C)
    int8 or fp32; values: (nb, nnz, F) of the same dtype; indices:
    (nb, nnz, F) int8, or (nb, nnz, F/g) for ``fmt.group = g``, read in
    place. int8 runs on the tensor cores and needs C % 8 == 0 and K within
    ``core.MMA_MAX_K`` (:func:`core.mma_plan`). ``choice`` as
    :func:`vdbb_im2col_conv_tc`'s. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return vdbb_im2col_conv_bw_plain(
            x, values, indices, fmt, kh, kw, scales=scales, bias=bias, relu=relu,
            out_scale=out_scale, stride=stride, padding=padding)
    geom, ep = _plan(x, values, indices, fmt, kh, kw, stride, padding, scales, bias, relu,
                     out_scale)
    return _launch_bw(x, values, indices, fmt, kh, kw, geom, ep, choice)


def _launch_bw(x, values, indices, fmt, kh, kw, geom, ep, choice=None):
    """The bw kernel on CUDA operands, the conv geometry and the flush
    resolved; ``choice`` as :func:`_launch_tc`'s."""
    (sh, sw), (ph, pw), (ho, wo) = geom
    if values.dtype != x.dtype or indices.dtype != torch.int8 or indices.dim() != 3:
        raise TypeError("vdbb_conv_bw: values must match x's dtype, indices be "
                        "(nb, nnz, F/g) int8")
    in_kind = build.check_operands("vdbb_conv_bw", x, values, indices, dtype=x.dtype)
    n, h, w, c = x.shape
    f = values.shape[-1]
    rows = _rows(_mma(False, x.shape, values, fmt, kh, kw, geom, x.data_ptr(), choice))
    out = torch.empty((n, ho, wo, f), dtype=ep.out_dtype, device=x.device)
    BW_KERNEL.launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), build.pointer(ep.scale),
        build.pointer(ep.bias), build.pointer(ep.out_scale), int(ep.relu),
        out.data_ptr(), in_kind, build.out_kind(ep.out_dtype), n, h, w, c, f,
        ho, wo, kh, kw, sh, sw, ph[0], pw[0], fmt.bz, fmt.nnz, f // indices.shape[2], rows,
        build.stream_of(x),
    )
    return out


def _shared(dw: DBBWeight) -> bool:
    """True when one pattern is shared across all F outputs (the tc kernel)."""
    return dw.fmt.group_size(dw.shape[1]) == dw.shape[1]


def vdbb_im2col_conv(x, dw: DBBWeight, kh: int, kw: int, **kw_args):
    """Fused sparse conv over a compressed DBBWeight, dispatching on its
    pattern-sharing mode: shared across F runs the tc kernel, per-column or
    grouped patterns the bw kernel (grouped indices read in place)."""
    if _shared(dw):
        return vdbb_im2col_conv_tc(x, dw.values, dw.indices[:, :, 0].contiguous(),
                                   dw.fmt, kh, kw, **kw_args)
    return vdbb_im2col_conv_bw(x, dw.values, dw.indices, dw.fmt, kh, kw, **kw_args)


def stage_vdbb_im2col_conv(dw: DBBWeight, kh: int, kw: int, x_shape, *, scales=None,
                           bias=None, relu=False, out_scale=None, stride=1, padding="SAME",
                           choice=None):
    """:func:`vdbb_im2col_conv` with the weight's side resolved once, for a
    plan (``models/plan.py``): the kernel for the pattern mode, the tc
    kernel's shared index row, the flush rows, and the int8 tile plan at
    ``x_shape`` (the bw plan's chunk for an input at an allocation's start,
    as every input of a plan is): its tile rows ``choice``'s, else the tuned
    registry's at the build, else the rule's. Returns ``(run, tiles)``:
    ``run(x)`` is the conv (the plain version for a CPU tensor, the kernel
    for a CUDA one, launched with the tile rows frozen here)."""
    tc = _shared(dw)
    values = dw.values
    idx = dw.indices[:, :, 0].contiguous() if tc else dw.indices
    geom = _geometry(x_shape, values, idx, dw.fmt, kh, kw, stride, padding)
    ep = epilogue_plan(values.shape[-1], values.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(values.dtype))
    tiles, frozen = {}, None
    plan = _mma(tc, x_shape, values, dw.fmt, kh, kw, geom, 0, choice)
    if plan is not None:  # the tensor-core instantiation (csrc/os_mma.cuh)
        tiles, frozen = dataclasses.asdict(plan), {"tile_rows": plan.tile_rows}
    plain = vdbb_im2col_conv_tc_plain if tc else vdbb_im2col_conv_bw_plain
    launch = _launch_tc if tc else _launch_bw

    def run(x):
        if x.device.type == "cpu":
            return plain(x, values, idx, dw.fmt, kh, kw, **ep.flush_kw, stride=stride, padding=padding)
        geom = _geometry(x.shape, values, idx, dw.fmt, kh, kw, stride, padding)
        return launch(x, values, idx, dw.fmt, kh, kw, geom, ep, choice=frozen)

    return run, tiles
