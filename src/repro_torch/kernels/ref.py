"""Plain PyTorch oracles for every kernel (port of ``repro/kernels/ref.py``).

Layouts are the reference's: NHWC activations, HWIO conv weights. Integer
oracles are exact (``quant.int_matmul_ref``). The fp32 oracles run their
products and convolutions with TF32 off (:func:`full_fp32`), so on the card
they are full float32; the flags are restored after each call.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.quant import as_f32, int_matmul_ref
from repro_torch.core.vdbb import (  # noqa: F401  (re-exported oracles)
    DBBFormat,
    DBBWeight,
    dbb_decode,
    dbb_decode_conv,
    dbb_matmul_gather_ref,
    dbb_matmul_ref,
)
from repro_torch.kernels.core import _pair, conv_geometry


@contextlib.contextmanager
def full_fp32():
    """Full-precision fp32 products and convolutions on the card inside the
    block, and bf16 products accumulated in fp32 (no reduced-precision
    split-K reduction); the flags are as they were after it."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32, torch.backends.cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


def acc_matmul(a, b):
    """A product in the kernels' accumulator type: exact int32 for integer
    operands, full fp32 otherwise. bf16 operands are widened first (each
    product is then exact in fp32, as in the kernel), so the result is the
    fp32 sum on every device, never a bf16 product."""
    if not a.dtype.is_floating_point:
        return int_matmul_ref(a, b)
    with full_fp32():
        return a.float() @ b.to(a.dtype).float()


def decode_values(values, indices, fmt):
    """Dense (nb·bz, N) weight from compressed ``values`` (nb, nnz, N) and
    ``indices``: (nb, nnz) shared across N, (nb, nnz, N) per column or
    (nb, nnz, N/g) shared by groups of g neighbouring columns."""
    nb, nnz, n = values.shape
    if indices.dim() == 2:
        indices = indices[:, :, None].expand(nb, nnz, n)
    elif indices.shape[2] != n:
        indices = indices.repeat_interleave(n // indices.shape[2], dim=2)
    fmt_pc = dataclasses.replace(fmt, group=None)
    return dbb_decode(DBBWeight(values, indices.to(torch.int8), fmt_pc, (nb * fmt.bz, n)))


def vdbb_matmul_ref(a, values, indices, fmt):
    """Oracle shared by tc and bw: expand to dense, then multiply."""
    w = decode_values(values, indices, fmt).to(a.dtype)
    with full_fp32():
        return a @ w


def vdbb_matmul_int_ref(a, values, indices, fmt):
    """Integer oracle: (M, K) int8 × expanded int8 weight -> exact int32."""
    return int_matmul_ref(a, decode_values(values, indices, fmt))


def quant_epilogue_ref(acc, scale, *, bias=None, relu=False, out_scale=None):
    """Dequantize → bias → ReLU → requantize-to-int8 on the last axis, one
    rounding per step; int8 codes when ``out_scale`` is given, else fp32."""
    y = acc.float() * as_f32(scale, acc.device)
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is not None:
        q = torch.round(y / as_f32(out_scale, y.device))
        return q.clamp(-127, 127).to(torch.int8)
    return y


def im2col_explicit(x, kh, kw, *, stride=1, padding="SAME"):
    """Explicit im2col: (N, Ho, Wo, kh·kw·C), K ordered (dy, dx, c)."""
    n, h, w, c = x.shape
    (sh, sw), (ph, pw), (ho, wo) = conv_geometry(h, w, kh, kw, stride, padding)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    cols = [
        xp[:, dy: dy + (ho - 1) * sh + 1: sh, dx: dx + (wo - 1) * sw + 1: sw, :]
        for dy in range(kh)
        for dx in range(kw)
    ]
    return torch.cat(cols, dim=-1)


def im2col_conv_ref(x, w, *, stride=1, padding="SAME"):
    """Conv as explicit im2col + GEMM."""
    kh, kw, c, f = w.shape
    cols = im2col_explicit(x, kh, kw, stride=stride, padding=padding)
    with full_fp32():
        return (cols @ w.reshape(kh * kw * c, f).to(x.dtype)).to(x.dtype)


def conv_lax_ref(x, w, *, stride=1, padding="SAME"):
    """Native conv oracle (NHWC, HWIO) through ``F.conv2d`` with explicit,
    XLA-convention padding."""
    kh, kw, _, _ = w.shape
    _, (ph, pw), _ = conv_geometry(x.shape[1], x.shape[2], kh, kw, stride, padding)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    with full_fp32():
        y = F.conv2d(xp, w.permute(3, 2, 0, 1).to(x.dtype), stride=_pair(stride))
    return y.permute(0, 2, 3, 1).contiguous()


def sparse_conv_ref(x, dw, kh, kw, *, stride=1, padding="SAME"):
    """Decode the compressed conv weight, then the native conv."""
    return conv_lax_ref(x, dbb_decode_conv(dw, kh, kw).to(x.dtype),
                        stride=stride, padding=padding)


def sparse_conv_int_ref(x, dw, kh, kw, *, stride=1, padding="SAME"):
    """Integer oracle for the int8 fused conv: explicit im2col + exact int32
    GEMM over the decoded int8 weight. Returns (N, Ho, Wo, F) int32."""
    cols = im2col_explicit(x, kh, kw, stride=stride, padding=padding)
    n, ho, wo, kk = cols.shape
    acc = int_matmul_ref(cols.reshape(-1, kk), dbb_decode(dw))
    return acc.reshape(n, ho, wo, -1)


# ---------------------------------------------------------------------------
# bf16 agreement of the kernel and its plain version
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bf16 ulp at each |x| (the subnormal step at 0)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def bf16_reorder_bound(a, values, indices, bz):
    """The bound on the difference of two fp32 sums of the same K_c exact
    products of a bf16 tc matmul (A (M, K), ``values`` (nb, nnz, N),
    ``indices`` (nb, nnz)) taken in different orders: K_c·2^-24·Σ|a||w|."""
    from repro_torch.core.vdbb import gather_compressed

    kc, n = values.shape[0] * values.shape[1], values.shape[-1]
    return (gather_compressed(a.float().abs(), indices, bz)
            @ values.float().abs().reshape(kc, n)) * (kc * 2.0**-24)


def check_bf16(got, want, order, what: str = "bf16") -> tuple:
    """Raise ``AssertionError`` unless every entry of ``got`` lies within one
    bf16 ulp (of the larger of the two values) plus ``order`` of ``want``:
    the kernel and its plain version sum the same exact products in
    different orders, so their fp32 values before the final rounding differ
    by at most ``order``, and each rounding moves a value by at most half an
    ulp. That bound is loose at a large K, so at most 0.1 % of the entries
    may lie beyond one ulp of |want| alone (near zero, where the sums' order
    sets the leading bits). Returns (the largest difference, the entries
    beyond one ulp of |want|)."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against the plain "
                             f"version's {want.dtype} {tuple(want.shape)}")
    d = (got.float() - want.float()).abs()
    beyond = d > bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + order
    if bool(beyond.any()):
        raise AssertionError(f"{what}: {int(beyond.sum())} entries beyond one bf16 ulp plus the "
                             f"fp32 reordering bound (max diff {float(d.max())})")
    past_ulp = int((d > bf16_ulp(want)).sum())
    if past_ulp > 1e-3 * d.numel():
        raise AssertionError(f"{what}: {past_ulp} of {d.numel()} entries beyond one bf16 ulp of "
                             "the plain version's, above 0.1 %")
    return float(d.max()), past_ulp
