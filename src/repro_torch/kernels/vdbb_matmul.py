"""VDBB sparse matmul (port of ``repro/kernels/vdbb_matmul.py``): the CUDA
kernels ``csrc/vdbb_matmul_tc.cu`` for a pattern shared across N (tc mode)
and ``csrc/vdbb_matmul_bw.cu`` for a pattern per column or per group of
columns (bw mode), each beside its plain PyTorch version."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.vdbb import DBBWeight, gather_compressed
from repro_torch.kernels import build
from repro_torch.kernels.build import I, P
from repro_torch.kernels.core import (acc_dtype_for, apply_epilogue, bf16_mma_plan, check_indices,
                                      epilogue_plan, mma_gather_plan, mma_plan)
from repro_torch.kernels.ref import acc_matmul, decode_values

KERNEL = build.CudaKernel(
    "vdbb_matmul_tc", "vdbb_matmul_tc.cu",
    [P, P, P, P, P, P, I, P, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/vdbb_matmul.py:65 _vdbb_tc_kernel",
    variants=("bf16",),
)

BW_KERNEL = build.CudaKernel(
    "vdbb_matmul_bw", "vdbb_matmul_bw.cu",
    [P, P, P, P, P, P, I, P, I, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/vdbb_matmul.py:169 _vdbb_bw_kernel",
)


def _check(a_shape, values, indices, fmt):
    m, k = a_shape
    nb, nnz, n = values.shape
    if nb * fmt.bz != k:
        raise ValueError(f"K={k} != nb*bz = {nb}*{fmt.bz}")
    if nnz != fmt.nnz:
        raise ValueError(f"values nnz={nnz} != fmt.nnz={fmt.nnz}")
    check_indices(indices, nb, nnz, n, fmt.group_size(n))


def _plan(a, values, indices, fmt, scales, bias, relu, out_scale):
    _check(a.shape, values, indices, fmt)
    return epilogue_plan(values.shape[-1], a.device, scales=scales, bias=bias, relu=relu,
                         out_scale=out_scale, acc_dtype=acc_dtype_for(a.dtype), in_dtype=a.dtype)


def vdbb_matmul_tc_plain(a, values, indices, fmt, *, scales=None, bias=None,
                         relu=False, out_scale=None):
    """Plain version: the activation mux, one product over the compressed K,
    the plain flush."""
    ep = _plan(a, values, indices, fmt, scales, bias, relu, out_scale)
    nb, nnz, n = values.shape
    acc = acc_matmul(gather_compressed(a, indices, fmt.bz), values.reshape(nb * nnz, n))
    return apply_epilogue(acc, ep)


def vdbb_matmul_tc(a, values, indices, fmt, *, scales=None, bias=None,
                   relu=False, out_scale=None):
    """A (M, K) × compressed W -> (M, N). values: (nb, nnz, N) of A's dtype
    (int8, fp32 or bf16); indices: (nb, nnz) int8, shared across N. Any M;
    ragged edges are masked in the kernel. int8 runs on the tensor cores and
    needs the compressed K = nb * nnz within ``core.MMA_MAX_K``
    (:func:`core.mma_gather_plan`); bf16 runs on the bf16 tensor cores
    (:func:`core.bf16_mma_plan`: an even K and a 4-byte aligned A), counts its
    launches as ``vdbb_matmul_tc_bf16`` and returns bf16 unless requantizing.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return vdbb_matmul_tc_plain(a, values, indices, fmt, scales=scales,
                                    bias=bias, relu=relu, out_scale=out_scale)
    ep = _plan(a, values, indices, fmt, scales, bias, relu, out_scale)
    return _launch_tc(a, values, indices, fmt, ep)


def _launch_tc(a, values, indices, fmt, ep):
    """The tc kernel on CUDA operands, the flush resolved."""
    if values.dtype != a.dtype or indices.dtype != torch.int8 or indices.dim() != 2:
        raise TypeError("vdbb_matmul_tc: values must match a's dtype, indices be (nb, nnz) int8")
    m, k = a.shape
    n = values.shape[-1]
    if a.dtype == torch.int8:  # the tensor-core instantiation (csrc/os_mma.cuh)
        mma_gather_plan("vdbb_matmul_tc", m, values.shape[0] * values.shape[1])
    elif a.dtype == torch.bfloat16:  # csrc/bf16_mma.cuh
        bf16_mma_plan("vdbb_matmul_tc", m, n, values.shape[0] * values.shape[1],
                      (a.data_ptr(), values.data_ptr()), k=k)
    in_kind = build.check_operands("vdbb_matmul_tc", a, values, indices, dtype=a.dtype,
                                   bf16=True)
    out = torch.empty((m, n), dtype=ep.out_dtype, device=a.device)
    KERNEL.launch(
        a.data_ptr(), values.data_ptr(), indices.data_ptr(), build.pointer(ep.scale),
        build.pointer(ep.bias), build.pointer(ep.out_scale), int(ep.relu),
        out.data_ptr(), in_kind, build.out_kind(ep.out_dtype), m, k, n, fmt.bz,
        fmt.nnz, build.stream_of(a), variant="bf16" if a.dtype == torch.bfloat16 else "",
    )
    return out


def vdbb_matmul_bw_plain(a, values, indices, fmt, *, scales=None, bias=None,
                         relu=False, out_scale=None):
    """Plain version of the per-column (bw) matmul: expand to the dense
    weight, one product over the dense K, the plain flush."""
    ep = _plan(a, values, indices, fmt, scales, bias, relu, out_scale)
    return apply_epilogue(acc_matmul(a, decode_values(values, indices, fmt)), ep)


def vdbb_matmul_bw(a, values, indices, fmt, *, scales=None, bias=None,
                   relu=False, out_scale=None):
    """A (M, K) × compressed W -> (M, N) with a pattern per column. values:
    (nb, nnz, N) of A's dtype; indices: (nb, nnz, N) int8, or (nb, nnz, N/g)
    for ``fmt.group = g``, read in place (never repeated per column). int8
    runs on the tensor cores and needs K % 8 == 0 and K within
    ``core.MMA_MAX_K`` (:func:`core.mma_plan`). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return vdbb_matmul_bw_plain(a, values, indices, fmt, scales=scales,
                                    bias=bias, relu=relu, out_scale=out_scale)
    ep = _plan(a, values, indices, fmt, scales, bias, relu, out_scale)
    return _launch_bw(a, values, indices, fmt, ep)


def _launch_bw(a, values, indices, fmt, ep):
    """The bw kernel on CUDA operands, the flush resolved."""
    if values.dtype != a.dtype or indices.dtype != torch.int8 or indices.dim() != 3:
        raise TypeError("vdbb_matmul_bw: values must match a's dtype, indices be "
                        "(nb, nnz, N/g) int8")
    in_kind = build.check_operands("vdbb_matmul_bw", a, values, indices, dtype=a.dtype)
    m, k = a.shape
    n = values.shape[-1]
    if a.dtype == torch.int8:  # the tensor-core instantiation (csrc/os_mma.cuh)
        mma_plan("vdbb_matmul_bw", m, k, k, a.data_ptr())
    out = torch.empty((m, n), dtype=ep.out_dtype, device=a.device)
    BW_KERNEL.launch(
        a.data_ptr(), values.data_ptr(), indices.data_ptr(), build.pointer(ep.scale),
        build.pointer(ep.bias), build.pointer(ep.out_scale), int(ep.relu),
        out.data_ptr(), in_kind, build.out_kind(ep.out_dtype), m, k, n, fmt.bz,
        fmt.nnz, n // indices.shape[2], build.stream_of(a),
    )
    return out


def stage_vdbb_matmul(w: DBBWeight, m: int, *, scales=None, bias=None, relu=False,
                      out_scale=None):
    """The product with a compressed weight ``w`` with the weight's side
    resolved once, for a plan (``models/plan.py``): the kernel for the
    pattern mode (shared across N: tc; per column or group: bw), the tc
    kernel's shared index row, the flush rows, and the tile plan at ``m``
    rows, int8 or bf16 (for an A at an allocation's start, as every input of
    a plan is). Returns ``(run, tiles)``: ``run(a)`` is the product (the
    plain version for a CPU tensor, the kernel for a CUDA one)."""
    k, n = w.shape
    tc = w.fmt.group_size(n) == n
    values = w.values
    idx = w.indices[:, :, 0].contiguous() if tc else w.indices
    _check((m, k), values, idx, w.fmt)
    ep = epilogue_plan(n, values.device, scales=scales, bias=bias, relu=relu,
                       out_scale=out_scale, acc_dtype=acc_dtype_for(values.dtype),
                       in_dtype=values.dtype)
    tiles = {}
    kc = values.shape[0] * values.shape[1]
    if values.dtype == torch.int8:  # the tensor-core instantiation (csrc/os_mma.cuh)
        tiles = dataclasses.asdict(mma_gather_plan("vdbb_matmul_tc", m, kc) if tc
                                   else mma_plan("vdbb_matmul_bw", m, k, k, 0))
    elif values.dtype == torch.bfloat16 and tc:  # csrc/bf16_mma.cuh
        tiles = dataclasses.asdict(
            bf16_mma_plan("vdbb_matmul_tc", m, n, kc, (0, values.data_ptr()), k=k))
    plain = vdbb_matmul_tc_plain if tc else vdbb_matmul_bw_plain
    launch = _launch_tc if tc else _launch_bw

    def run(a):
        if a.device.type == "cpu":
            return plain(a, values, idx, w.fmt, **ep.flush_kw)
        _check(a.shape, values, idx, w.fmt)
        return launch(a, values, idx, w.fmt, ep)

    return run, tiles
