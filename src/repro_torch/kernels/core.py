"""Shared pieces of the kernel layer (port of ``repro/kernels/core.py``):
conv geometry, the accumulator dtype rule and the fused flush-epilogue plan.

The TPU kernels carry an output-stationary accumulator across a sequential
K grid axis (``os_accumulate``). On the card each thread block owns an output
tile and loops over K itself; that loop and the flush epilogue live in
``csrc/os_gemm.cuh`` (the CUDA cores, fp32), ``csrc/os_mma.cuh`` (the int8
tensor cores, for the int8 instantiation of every compressed kernel),
``csrc/bf16_mma.cuh`` (the bf16 tensor cores, for the tc matmul's bf16
instantiation) and ``csrc/epilogue.cuh``.
What stays here is what the host resolves before a launch.
"""
from __future__ import annotations

import dataclasses

import torch

QMAX = 127  # symmetric int8 clip range of the requantize epilogue

# csrc/os_mma.cuh: the largest K whose int32 sum of int8 products is exact
# (K * 127 * 127 < 2**31), and the M at or below which it takes its small tile
MMA_MAX_K = (2**31 - 1) // (QMAX * QMAX)
MMA_SMALL_M = 64
# csrc/mux_stage.cuh (TapMux): a conv column's source packs its tap above a
# 27-bit offset from the row's tap-(0, 0) pixel, and a row keeps a 32-bit
# mask of its taps inside the image
MMA_MAX_TAPS = 32
MMA_TAP_OFFSET_LIMIT = 2**27
# csrc/bf16_mma.cuh: compressed columns a stage, the M at or below which it
# takes its small tile, and per tile (rows, columns, the largest split-K
# cluster); the split aims at the 132 SMs of an H100
BF16_BK = 32
BF16_SMALL_M = 16
BF16_TILES = {"small": (16, 128, 16), "large": (128, 256, 8)}
BF16_LARGE_STAGES = 4  # the large tile's ring
BF16_SMS = 132


def _pair(v):
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def conv_geometry(h: int, w: int, kh: int, kw: int, stride, padding):
    """Resolve stride / padding / output size for a 2-D conv.

    ``padding``: 'SAME' | 'VALID' | ((top, bottom), (left, right)). Returns
    ``((sh, sw), ((pt, pb), (pl, pr)), (ho, wo))`` with XLA's SAME convention:
    the extra pad row or column goes at the end.
    """
    sh, sw = _pair(stride)

    def one(dim, k, s, pad):
        if pad == "SAME":
            o = -(-dim // s)
            total = max((o - 1) * s + k - dim, 0)
            return (total // 2, total - total // 2), o
        if pad == "VALID":
            if dim < k:
                raise ValueError(f"VALID conv: dim {dim} < kernel {k}")
            return (0, 0), (dim - k) // s + 1
        lo, hi = pad
        return (int(lo), int(hi)), (dim + lo + hi - k) // s + 1

    if isinstance(padding, str):
        padding = padding.upper()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID', or explicit pairs; got {padding!r}")
        (ph, ho), (pw, wo) = one(h, kh, sh, padding), one(w, kw, sw, padding)
    else:
        (ph, ho), (pw, wo) = one(h, kh, sh, padding[0]), one(w, kw, sw, padding[1])
    if ho < 1 or wo < 1:
        raise ValueError(f"empty conv output {(ho, wo)}")
    return (sh, sw), (ph, pw), (ho, wo)


def check_indices(indices: torch.Tensor, nb: int, nnz: int, n: int, group: int = 1) -> None:
    """Positions of a compressed weight: (nb, nnz) shared across N,
    (nb, nnz, N) per column, or (nb, nnz, N/group) for a grouped weight.
    The kernels index through them unchecked."""
    shapes = [(nb, nnz), (nb, nnz, n)]
    if group > 1 and n % group == 0:
        shapes.append((nb, nnz, n // group))
    if tuple(indices.shape) not in shapes:
        raise ValueError(f"indices {tuple(indices.shape)}: expected one of {shapes}")


def acc_dtype_for(operand_dtype: torch.dtype) -> torch.dtype:
    """Exact int32 for integer (int8) operands, fp32 otherwise."""
    return torch.float32 if operand_dtype.is_floating_point else torch.int32


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """The fused accumulator-flush epilogue, resolved on the host: (N,) fp32
    rows for the dequant ``scale``, the ``bias`` and the requantize
    ``out_scale`` (each None when absent), the ReLU flag, and the output
    dtype."""

    scale: torch.Tensor | None
    bias: torch.Tensor | None
    out_scale: torch.Tensor | None
    relu: bool
    out_dtype: torch.dtype

    @property
    def flush_kw(self) -> dict:
        """The resolved flush as the plain versions' keyword arguments."""
        return dict(scales=self.scale, bias=self.bias, relu=self.relu, out_scale=self.out_scale)


def epilogue_plan(n: int, device, *, scales=None, bias=None, relu=False,
                  out_scale=None, acc_dtype, in_dtype=None) -> Epilogue:
    """Rows broadcast to (n,) fp32 on ``device`` (a scalar ``out_scale``
    broadcasts across N), and the output dtype: int8 when requantizing, else
    bf16 for bf16 operands (``in_dtype``; the fp32 sum rounded once), fp32
    when a scale or bias touches the accumulator, else the raw accumulator
    dtype."""

    def row(v):
        if v is None:
            return None
        v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
        return v.expand(n).contiguous()

    if out_scale is not None:
        out_dtype = torch.int8
    elif in_dtype == torch.bfloat16:
        out_dtype = torch.bfloat16
    elif scales is not None or bias is not None:
        out_dtype = torch.float32
    else:
        out_dtype = acc_dtype
    return Epilogue(row(scales), row(bias), row(out_scale), bool(relu), out_dtype)


def apply_epilogue(acc: torch.Tensor, ep: Epilogue) -> torch.Tensor:
    """The plain flush, in the kernels' order: dequantize, add the bias,
    ReLU, requantize (round half to even, clip to ±QMAX). One separate op
    per step, so each rounds once, as the reference does. NaN passes ReLU
    and requantizes to code 0 on every device (the card's cast of a NaN to
    int8 is not relied on)."""
    y = acc
    if ep.scale is not None:
        y = y.float() * ep.scale
    if ep.bias is not None:
        y = y.float() + ep.bias
    if ep.relu:
        y = torch.clamp_min(y, 0)
    if ep.out_scale is not None:
        y = torch.round(y.float() / ep.out_scale).clamp(-QMAX, QMAX).nan_to_num(nan=0.0)
    return y.to(ep.out_dtype)


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """How ``csrc/os_mma.cuh`` runs one int8 product: ``tile_rows`` output
    rows per block, A stored in ``chunk``-byte pieces (copied by cp.async,
    or gathered through registers when ``gathered``)."""

    tile_rows: int
    chunk: int
    gathered: bool = False


def _mma_check_k(name: str, k: int) -> None:
    if k > MMA_MAX_K:
        raise ValueError(f"{name}: K={k} above {MMA_MAX_K}, where K*127*127 would "
                         "overflow the exact int32 accumulator")


def _mma_tile_rows(m: int) -> int:
    return 64 if m <= MMA_SMALL_M else 128


def mma_plan(name: str, m: int, k: int, run: int, ptr: int) -> MmaPlan:
    """The int8 tensor-core GEMM's choices for an (m, k) product whose A
    rows are read in runs of ``run`` contiguous bytes (a conv's C: the
    channels of one tap; a matrix's K) starting at address ``ptr``. The
    kernel makes the same choices; this raises on what it does not take.

    - tile rows: 64 for m <= 64 (the head, the deep layers at batch 1),
      else 128;
    - chunk: 16 bytes when ``run`` % 16 == 0 and ``ptr`` is 16-byte
      aligned, else 8 bytes under the same two conditions, else refused;
    - k above ``MMA_MAX_K`` is refused: the int32 sum would not be exact.
    """
    _mma_check_k(name, k)
    for chunk in (16, 8):
        if run % chunk == 0 and ptr % chunk == 0:
            return MmaPlan(_mma_tile_rows(m), chunk)
    raise ValueError(f"{name}: int8 operand rows come in runs of {run} bytes at address "
                     f"{ptr:#x}; the kernel copies 16- or 8-byte aligned chunks")


def mma_gather_plan(name: str, m: int, kc: int) -> MmaPlan:
    """The same choices for a product over a gathered A (the tc kernels'
    activation mux, ``csrc/mux_stage.cuh``): tile rows as :func:`mma_plan`;
    A gathered byte by byte through registers, so neither alignment nor the
    length of a run matters, on the core's 8-byte instance; a compressed K
    ``kc`` above ``MMA_MAX_K`` is refused."""
    _mma_check_k(name, kc)
    return MmaPlan(_mma_tile_rows(m), 8, gathered=True)


def mma_tap_plan(name: str, m: int, kc: int, kh: int, kw: int, w: int, c: int) -> MmaPlan:
    """:func:`mma_gather_plan` for the tc conv's gather over the taps of a
    kh x kw conv on an NHWC input of width ``w`` and ``c`` channels
    (``TapMux``, ``csrc/mux_stage.cuh``). Also refuses what the stager's
    packing cannot hold: more than ``MMA_MAX_TAPS`` taps, or a tap offset
    ((dy·w + dx)·c + ch) of ``MMA_TAP_OFFSET_LIMIT`` or more."""
    plan = mma_gather_plan(name, m, kc)
    if kh * kw > MMA_MAX_TAPS:
        raise ValueError(f"{name}: {kh}x{kw} = {kh * kw} taps, above the {MMA_MAX_TAPS} "
                         "a row's tap mask holds")
    if ((kh - 1) * w + kw) * c > MMA_TAP_OFFSET_LIMIT:
        raise ValueError(f"{name}: tap offsets up to (({kh} - 1) * {w} + {kw}) * {c} bytes "
                         f"reach the packed source's limit of {MMA_TAP_OFFSET_LIMIT}")
    return plan


@dataclasses.dataclass(frozen=True)
class Bf16MmaPlan:
    """How ``csrc/bf16_mma.cuh`` runs one bf16 product: a tile of
    ``tile_rows`` x ``tile_cols`` outputs a CTA, the compressed K split over
    a cluster of ``split`` CTAs (reduced in rank order through distributed
    shared memory), the values copied in ``b_chunk``-byte pieces (16: by
    cp.async; 2: element by element through registers)."""

    tile_rows: int
    tile_cols: int
    split: int
    b_chunk: int


def bf16_mma_plan(name: str, m: int, n: int, kc: int, ptrs, *, k: int) -> Bf16MmaPlan:
    """The bf16 tensor-core GEMM's choices for an (m, kc) x (kc, n) product
    over A (m, k) gathered to its ``kc`` compressed columns, with ``ptrs`` =
    (A's address, the values' address). The kernel makes the same choices;
    this raises on what it does not take.

    - tile: 16 x 128 for m <= 16 (decode), else 128 x 256, both in
      32-deep stages;
    - split, at most the ceil(kc / 32) stages: on the small tile (bound
      by bytes) 1 where the tiles fill the 132 SMs, else ceil(132 / tiles)
      up to 16 CTAs a cluster; on the large tile (bound by operations, one
      CTA an SM) 1 from 4 waves of tiles on, else the s up to 8 with the
      fewest stage times over its waves, ceil(tiles * s / 132) *
      (ceil(stages / s) + 4), the + 4 (its ring) a CTA's filling of its
      ring and its flush or reduction;
    - B chunk: 16 bytes when n % 8 == 0 and the values are 16-byte aligned,
      else 2 (through registers);
    - A must be 4-byte aligned with an even k: the gather copies the aligned
      4-byte word that holds each element.
    """
    a_ptr, v_ptr = ptrs
    if a_ptr % 4 or k % 2:
        raise ValueError(f"{name}: bf16 A of {k} columns at address {a_ptr:#x}; the gather "
                         "copies aligned 4-byte words, so it needs an even K and a 4-byte "
                         "aligned A")
    small = m <= BF16_SMALL_M
    rows, cols, max_split = BF16_TILES["small" if small else "large"]
    tiles = -(-m // rows) * -(-n // cols)
    stages = -(-kc // BF16_BK)
    most = min(max_split, stages)
    if small:
        split = 1 if tiles >= BF16_SMS else min(-(-BF16_SMS // tiles), most)
    elif tiles >= 4 * BF16_SMS:
        split = 1
    else:
        costs = [-(-tiles * s // BF16_SMS) * (-(-stages // s) + BF16_LARGE_STAGES)
                 for s in range(1, most + 1)]
        split = 1 + costs.index(min(costs))
    chunk = 16 if n % 8 == 0 and v_ptr % 16 == 0 else 2
    return Bf16MmaPlan(rows, cols, split, chunk)
