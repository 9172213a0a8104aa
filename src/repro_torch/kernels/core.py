"""Shared pieces of the kernel layer (port of ``repro/kernels/core.py``):
conv geometry, the accumulator dtype rule and the fused flush-epilogue plan.

The TPU kernels carry an output-stationary accumulator across a sequential
K grid axis (``os_accumulate``). On the card each thread block owns an output
tile and loops over K itself; that loop and the flush epilogue live in
``csrc/os_gemm.cuh`` (the CUDA cores, fp32), ``csrc/os_mma.cuh`` (the int8
tensor cores, for the int8 instantiation of every compressed kernel),
``csrc/bf16_mma.cuh`` (the bf16 tensor cores, for the tc matmul's bf16
instantiation) and ``csrc/epilogue.cuh``.
What stays here is what the host resolves before a launch: among it each
kernel's launch choices (the int8 tile rows, the bf16 tile and split, the
dense conv's path), which the kernels take as arguments and only validate.
The choices follow a rule by shape unless the tuned registry
(:func:`set_tuned`, written by ``kernels/autotune.py``) holds a measured one
for the launch's kind and signature.
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
# csrc/os_mma.cuh's two tile instances (rows), its tile's columns, the bytes
# of K a stage, its A ring and the blocks an SM holds (2 to 3)
MMA_TILE_ROWS = (64, 128)
MMA_TILE_COLS = 64
MMA_BK = 64
MMA_STAGES = 3
MMA_BLOCKS_PER_SM = 2
# csrc/bf16_mma.cuh: the rings of the small and the large tile, CTAs an SM
BF16_STAGES = {"small": 8, "large": BF16_LARGE_STAGES}
BF16_BLOCKS_PER_SM = {"small": 2, "large": 1}
# csrc/im2col_conv.cu, namespace direct_conv: a block's output tile (rows,
# columns), its floats per weight row (64 filters in groups of 8, each
# padded to 12), and the shared memory the wrapper lets its halo and weight
# slice take
DIRECT_TILE = (4, 32)
DIRECT_WROW = 96
DIRECT_SMEM_BYTES = 48 * 1024


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


def _chosen(key, choice) -> dict:
    """The launch choice a plan takes: ``choice`` when given (a plan's,
    frozen at its build; ``{}`` asks for the rule), else the registry's
    entry for ``key`` = (kind, signature), else {} (the plan's own rule)."""
    if choice is not None:
        return dict(choice)
    return dict(lookup_tiles(*key) or {}) if key is not None else {}


def mma_plan(name: str, m: int, k: int, run: int, ptr: int, *, key=None,
             choice=None) -> MmaPlan:
    """The int8 tensor-core GEMM's choices for an (m, k) product whose A
    rows are read in runs of ``run`` contiguous bytes (a conv's C: the
    channels of one tap; a matrix's K) starting at address ``ptr``. The
    kernel takes them as arguments and refuses what it cannot run; this
    raises on what it does not take.

    - tile rows: ``choice``'s, else the tuned registry's for ``key`` (kind,
      signature), else the rule: 64 for m <= 64 (the head, the deep layers
      at batch 1), else 128;
    - chunk: 16 bytes when ``run`` % 16 == 0 and ``ptr`` is 16-byte
      aligned, else 8 bytes under the same two conditions, else refused
      (alignment belongs to the call, so it is never tuned);
    - k above ``MMA_MAX_K`` is refused: the int32 sum would not be exact.
    """
    _mma_check_k(name, k)
    rows = _chosen(key, choice).get("tile_rows") or _mma_tile_rows(m)
    for chunk in (16, 8):
        if run % chunk == 0 and ptr % chunk == 0:
            return MmaPlan(rows, chunk)
    raise ValueError(f"{name}: int8 operand rows come in runs of {run} bytes at address "
                     f"{ptr:#x}; the kernel copies 16- or 8-byte aligned chunks")


def mma_gather_plan(name: str, m: int, kc: int, *, key=None, choice=None) -> MmaPlan:
    """The same choices for a product over a gathered A (the tc kernels'
    activation mux, ``csrc/mux_stage.cuh``): tile rows as :func:`mma_plan`;
    A gathered byte by byte through registers, so neither alignment nor the
    length of a run matters, on the core's 8-byte instance; a compressed K
    ``kc`` above ``MMA_MAX_K`` is refused."""
    _mma_check_k(name, kc)
    return MmaPlan(_chosen(key, choice).get("tile_rows") or _mma_tile_rows(m), 8, gathered=True)


def mma_tap_plan(name: str, m: int, kc: int, kh: int, kw: int, w: int, c: int, *, key=None,
                 choice=None) -> MmaPlan:
    """:func:`mma_gather_plan` for the tc conv's gather over the taps of a
    kh x kw conv on an NHWC input of width ``w`` and ``c`` channels
    (``TapMux``, ``csrc/mux_stage.cuh``). Also refuses what the stager's
    packing cannot hold: more than ``MMA_MAX_TAPS`` taps, or a tap offset
    ((dy·w + dx)·c + ch) of ``MMA_TAP_OFFSET_LIMIT`` or more."""
    plan = mma_gather_plan(name, m, kc, key=key, choice=choice)
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


def _bf16_rule(m: int, n: int, kc: int) -> tuple:
    """The bf16 GEMM's (tile, split) by shape: see :func:`bf16_mma_plan`."""
    small = m <= BF16_SMALL_M
    tile = "small" if small else "large"
    rows, cols, max_split = BF16_TILES[tile]
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
    return tile, split


def bf16_mma_plan(name: str, m: int, n: int, kc: int, ptrs, *, k: int, key=None,
                  choice=None) -> Bf16MmaPlan:
    """The bf16 tensor-core GEMM's choices for an (m, kc) x (kc, n) product
    over A (m, k) gathered to its ``kc`` compressed columns, with ``ptrs`` =
    (A's address, the values' address). The kernel takes the tile and the
    split as arguments and refuses what it cannot run; this raises on what
    it does not take.

    - tile and split: ``choice``'s (``{"tile": "small" | "large",
      "split": s}``), else the tuned registry's for ``key`` (kind,
      signature), else the rule:
    - tile: 16 x 128 for m <= 16 (decode), else 128 x 256, both in
      32-deep stages;
    - split, at most the ceil(kc / 32) stages: on the small tile (bound
      by bytes) 1 where the tiles fill the 132 SMs, else ceil(132 / tiles)
      up to 16 CTAs a cluster; on the large tile (bound by operations, one
      CTA an SM) 1 from 4 waves of tiles on (beyond, a short last wave costs
      less than a split's ring fills and reduction: w_up's 576 tiles ran 8 %
      slower split in 2 on an H100), else the s up to 8 with the
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
    t = _chosen(key, choice)
    tile, split = (t["tile"], t["split"]) if t else _bf16_rule(m, n, kc)
    rows, cols, _ = BF16_TILES[tile]
    chunk = 16 if n % 8 == 0 and v_ptr % 16 == 0 else 2
    return Bf16MmaPlan(rows, cols, split, chunk)


def bf16_choice(plan: Bf16MmaPlan) -> dict:
    """The tuned registry's form of a bf16 plan's choice."""
    return {"tile": "small" if plan.tile_rows == BF16_TILES["small"][0] else "large",
            "split": plan.split}


def direct_smem_bytes(c: int, kh: int, kw: int, stride) -> int:
    """Shared memory of a direct-conv block (``csrc/im2col_conv.cu``): the
    fp32 input halo of its output tile (rounded up to 4 floats) and its
    weight slice, as the kernel sizes them (``HaloTile::smem_bytes``)."""
    (sh, sw), (th, tw) = _pair(stride), DIRECT_TILE
    halo = ((th - 1) * sh + kh) * ((tw - 1) * sw + kw) * c
    return 4 * (-(-halo // 4) * 4 + kh * kw * c * DIRECT_WROW)


def stem_paths(dtype, c: int, kh: int, kw: int, stride) -> list:
    """The dense conv kernel's legal paths at a shape, the rule's first:
    'direct' for fp32 operands whose block halo and weight slice fit
    ``DIRECT_SMEM_BYTES``, then 'gemm' (the implicit GEMM takes any shape)."""
    if dtype_name(dtype) == "float32" and direct_smem_bytes(c, kh, kw, stride) <= DIRECT_SMEM_BYTES:
        return ["direct", "gemm"]
    return ["gemm"]


# ---------------------------------------------------------------------------
# Tuned launch choices (the autotuner, ``kernels/autotune.py``, installs
# into this registry; the plans above consult it for their launch's kind and
# signature and, with no entry, keep their rule)
# ---------------------------------------------------------------------------

KIND_MATMUL_TC = "matmul_tc"
KIND_MATMUL_BW = "matmul_bw"
KIND_CONV_TC = "conv_tc"
KIND_CONV_BW = "conv_bw"
KIND_CONV_DENSE = "conv_dense"
KINDS = (KIND_MATMUL_TC, KIND_MATMUL_BW, KIND_CONV_TC, KIND_CONV_BW, KIND_CONV_DENSE)

_TUNED: dict = {}


def dtype_name(dtype) -> str:
    """The reference's dtype name: 'int8', 'bfloat16', 'float32'."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


def matmul_sig(m: int, k: int, n: int, bz: int, nnz: int, dtype) -> tuple:
    """Shape signature of one matmul-shaped launch (its kind carried
    separately), as the reference's."""
    return (int(m), int(k), int(n), int(bz), int(nnz), dtype_name(dtype))


def conv_sig(n: int, ho: int, wo: int, c: int, f: int, kh: int, kw: int,
             sh: int, sw: int, bz: int, nnz: int, dtype) -> tuple:
    """Shape signature of one conv launch (``bz = nnz = 0`` for the dense
    kernel), as the reference's; (ho, wo) subsumes the padding."""
    return (int(n), int(ho), int(wo), int(c), int(f), int(kh), int(kw),
            int(sh), int(sw), int(bz), int(nnz), dtype_name(dtype))


def _launch_m(kind: str, sig: tuple) -> int:
    return sig[0] if kind in (KIND_MATMUL_TC, KIND_MATMUL_BW) else sig[0] * sig[1] * sig[2]


def launch_choices(kind: str, sig: tuple) -> list:
    """Every launch choice the kernel of ``kind`` can run at ``sig``: tile
    rows 64 or 128 for an int8 product; the small or large tile with each
    split from 1 to min(the tile's largest cluster, the stages of K_c) for a
    bf16 tc matmul; the legal paths of the dense conv. [] where the launch
    has no choice (fp32 products on the CUDA cores)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of {KINDS}")
    dt = sig[-1]
    if kind == KIND_CONV_DENSE:
        _, _, _, c, _, kh, kw, sh, sw = sig[:9]
        return [{"path": p} for p in stem_paths(dt, c, kh, kw, (sh, sw))]
    if dt == "int8":
        return [{"tile_rows": r} for r in MMA_TILE_ROWS]
    if kind == KIND_MATMUL_TC and dt == "bfloat16":
        _, k, _, bz, nnz = sig[:5]
        stages = -(-(k // bz * nnz) // BF16_BK)
        return [{"tile": t, "split": s} for t, (_, _, most) in BF16_TILES.items()
                for s in range(1, min(most, stages) + 1)]
    return []


def default_choice(kind: str, sig: tuple):
    """The choice the plans' rule makes at ``sig`` (what a launch takes with
    an empty registry), or None where the launch has no choice."""
    if not launch_choices(kind, sig):
        return None
    if kind == KIND_CONV_DENSE:
        return launch_choices(kind, sig)[0]
    if sig[-1] == "int8":
        return {"tile_rows": _mma_tile_rows(_launch_m(kind, sig))}
    m, k, n, bz, nnz = sig[:5]
    tile, split = _bf16_rule(m, n, k // bz * nnz)
    return {"tile": tile, "split": split}


def _normal(tiles: dict) -> dict:
    try:
        return {k: (int(v) if k in ("tile_rows", "split") else str(v)) for k, v in tiles.items()}
    except (TypeError, ValueError, AttributeError):
        return {}


def check_choice(kind: str, sig: tuple, tiles) -> dict:
    """``tiles`` normalized, or ValueError unless it is one of
    :func:`launch_choices`."""
    entry = _normal(tiles) if isinstance(tiles, dict) else {}
    legal = launch_choices(kind, tuple(sig))
    if not entry or entry not in legal:
        raise ValueError(f"{kind} at {tuple(sig)}: {tiles!r} is not a launch choice the kernel "
                         f"runs ({legal or 'it has none'})")
    return entry


def lookup_tiles(kind: str, sig: tuple):
    """The installed choice for (kind, sig), or None when untuned."""
    return _TUNED.get((kind, tuple(sig)))


def set_tuned(kind: str, sig: tuple, tiles: dict) -> None:
    """Install a measured choice. It is validated first: an entry the kernel
    cannot run raises ValueError and installs nothing."""
    _TUNED[(kind, tuple(sig))] = check_choice(kind, sig, tiles)


def clear_tuned() -> None:
    _TUNED.clear()


def tuned_entries() -> dict:
    """A copy of the registry: {(kind, sig): choice}."""
    return {key: dict(t) for key, t in _TUNED.items()}
