"""Fused IM2COL convolution, dense weights (port of
``repro/kernels/im2col_conv.py``): the CUDA kernel ``csrc/im2col_conv.cu``
and its plain PyTorch version. NHWC input, HWIO weight; the optional
epilogue fuses bias, ReLU and the requantize to int8, so the fp32 stem of the
int8-resident chain is one kernel.

The kernel has two paths, chosen in :func:`conv_path` (by shape, or a tuned
entry): a direct conv (fp32, when a block's input halo and weight slice fit
``DIRECT_SMEM_BYTES`` of shared memory; the C = 3 stem) and an implicit GEMM
on ``csrc/os_gemm.cuh`` (int8, and fp32 at larger C)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P
# the direct path's budget lives in core, beside the registry that checks paths
from repro_torch.kernels.core import (DIRECT_SMEM_BYTES, KIND_CONV_DENSE,  # noqa: F401
                                      acc_dtype_for, apply_epilogue, conv_geometry, conv_sig,
                                      direct_smem_bytes, epilogue_plan, lookup_tiles, stem_paths)
from repro_torch.kernels.ref import acc_matmul, im2col_explicit

KERNEL = build.CudaKernel(
    "im2col_conv", "im2col_conv.cu",
    [P, P, P, P, P, I, P, I, I] + [I] * 14 + [P],
    replaces="src/repro/kernels/im2col_conv.py:73 _im2col_conv_kernel",
)


def conv_path(dtype: torch.dtype, c: int, kh: int, kw: int, stride, *, key=None,
              choice=None) -> str:
    """The path the kernel takes: ``choice``'s (``{"path": p}``; ``{}``
    takes the rule), else the tuned registry's for ``key`` (kind,
    signature), else the rule: 'direct' for fp32 operands whose block halo
    and weight slice fit ``DIRECT_SMEM_BYTES`` (the C = 3 stem at stride 1
    or 2 takes 13 or 16 KB), else 'gemm': int8 operands, and fp32 at a C too
    large for the budget (C = 16 at 3x3 needs 67 KB). Raises on a path the
    shape does not allow."""
    legal = stem_paths(dtype, c, kh, kw, stride)
    if choice is None:
        choice = (lookup_tiles(*key) if key is not None else None) or {}
    path = choice.get("path", legal[0])
    if path not in legal:
        raise ValueError(f"im2col_conv: path {path!r} at C={c}, {kh}x{kw}, stride {stride}, "
                         f"{dtype}; legal: {legal}")
    return path


def stem_key(x_shape, w_shape, geom, dtype) -> tuple:
    """The tuned registry's (kind, signature) of a dense conv launch."""
    (sh, sw), _, (ho, wo) = geom
    kh, kw, c, f = w_shape
    return KIND_CONV_DENSE, conv_sig(x_shape[0], ho, wo, c, f, kh, kw, sh, sw, 0, 0, dtype)


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
                stride=1, padding="SAME", choice=None):
    """Fused im2col conv. x: (N, H, W, C); w: (kh, kw, C, F), same dtype
    (int8 or fp32). CPU tensors take the plain version; CUDA tensors launch
    the kernel, on the path :func:`conv_path` picks for the launch
    (``choice``'s, ``{"path": p}``, when given)."""
    if x.device.type == "cpu":
        return im2col_conv_plain(x, w, scales=scales, bias=bias, relu=relu,
                                 out_scale=out_scale, stride=stride, padding=padding)
    geom, ep = _plan(x, w, stride, padding, scales, bias, relu, out_scale)
    return _launch(x, w, geom, ep, choice)


def _launch(x, w, geom, ep, choice=None):
    """The kernel on CUDA operands, the conv geometry and the flush resolved;
    ``choice`` a plan's path (``{"path": p}``), else :func:`conv_path`'s."""
    (sh, sw), (ph, pw), (ho, wo) = geom
    if w.dtype != x.dtype:
        raise TypeError(f"im2col_conv: x is {x.dtype}, w is {w.dtype}")
    in_kind = build.check_operands("im2col_conv", x, w, dtype=x.dtype)
    n, h, wd, c = x.shape
    kh, kw, _, f = w.shape
    direct = conv_path(x.dtype, c, kh, kw, (sh, sw), choice=choice,
                       key=stem_key(x.shape, w.shape, geom, x.dtype)) == "direct"
    out = torch.empty((n, ho, wo, f), dtype=ep.out_dtype, device=x.device)
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), build.pointer(ep.scale), build.pointer(ep.bias),
        build.pointer(ep.out_scale), int(ep.relu), out.data_ptr(), in_kind,
        build.out_kind(ep.out_dtype), n, h, wd, c, f, ho, wo, kh, kw, sh, sw,
        ph[0], pw[0], int(direct), build.stream_of(x),
    )
    return out


def stage_im2col_conv(w, x_shape, *, scales=None, bias=None, relu=False, out_scale=None,
                      stride=1, padding="SAME", choice=None):
    """:func:`im2col_conv` with the weight's side resolved once, for a plan
    (``models/plan.py``): the flush rows, and the path :func:`conv_path`
    takes at ``x_shape`` (the tuned registry's at the build, else the rule;
    ``choice`` overrides both). Returns ``(run, tiles)``: ``run(x)`` is the
    conv (the plain version for a CPU tensor, the kernel for a CUDA one, on
    the frozen path), and ``tiles`` records the path."""
    kh, kw, c, f = w.shape
    geom = _geometry(x_shape, w, stride, padding)
    ep = epilogue_plan(f, w.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(w.dtype))
    tiles = {"path": conv_path(w.dtype, c, kh, kw, stride, choice=choice,
                               key=stem_key(x_shape, w.shape, geom, w.dtype))}

    def run(x):
        if x.device.type == "cpu":
            return im2col_conv_plain(x, w, **ep.flush_kw, stride=stride, padding=padding)
        return _launch(x, w, _geometry(x.shape, w, stride, padding), ep, choice=tiles)

    return run, tiles
