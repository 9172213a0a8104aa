"""Activation sparsity: measure, gate, collect (port of
``repro/core/act_sparsity.py``).

* **measure**: :func:`zero_fraction` (what zero-operand clock gating sees),
  :func:`near_zero_fraction`, the per-block occupancy
  (:func:`block_nnz_counts`, :func:`block_nnz_histogram`) and
  :func:`measure_activation`, which gives an :class:`ActStats` with the
  ``absmax`` that ``quant.act_scale_from_stats`` turns into a static scale;
  :func:`combine` composes per-layer stats MAC-weighted.
* **gate**: the paper's DBB structure on the activation K-blocks, one
  pattern shared across the M tile (the tc co-design): :func:`act_dbb_mask`
  is ``vdbb.dbb_mask`` on the transposed tile, with its stable-sort tie
  rule (``jax.lax.top_k``'s), :func:`act_dbb_prune` zeroes the rest,
  :func:`act_dbb_encode` / :func:`act_dbb_decode` round-trip to it bit for
  bit, and :func:`act_fmt` picks the bound a measured density supports.
* **collect**: while a collector is installed (:func:`collect_activations`,
  ``LM.forward(..., collect_act_stats=True)``) every
  :func:`record_activation` lands in it under the current :func:`act_scope`
  path, e.g. ``g0.b1.mixer.wq``: the address ``LM.quantize`` looks a
  layer's calibrated scale up by.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence

import torch

from repro_torch.core.vdbb import (DBBFormat, DBBWeight, DEFAULT_BZ, dbb_decode, dbb_encode,
                                   dbb_mask)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def zero_fraction(x: torch.Tensor) -> torch.Tensor:
    """Exact fraction of zero entries (a 0-d fp32 tensor): what zero-operand
    clock gating sees."""
    return (x == 0).float().mean()


def near_zero_fraction(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Fraction with |x| <= ``threshold``: what threshold gating would gate."""
    return (x.abs() <= threshold).float().mean()


def block_nnz_counts(x: torch.Tensor, bz: int = DEFAULT_BZ) -> torch.Tensor:
    """Non-zeros per ``bz``-block along the last axis: (..., K/bz) int32.
    The feature dim must be blockable (K % bz == 0), as for weights."""
    k = x.shape[-1]
    if k % bz != 0:
        raise ValueError(f"feature dim K={k} not divisible by bz={bz}")
    return (x.reshape(*x.shape[:-1], k // bz, bz) != 0).sum(dim=-1).to(torch.int32)


def block_nnz_histogram(x: torch.Tensor, bz: int = DEFAULT_BZ) -> torch.Tensor:
    """(bz + 1,) int32 counts of blocks holding 0 … bz non-zeros: bin b is
    how many activation K-blocks a bound of nnz = b holds exactly."""
    counts = block_nnz_counts(x, bz).reshape(-1)
    bins = torch.arange(bz + 1, dtype=counts.dtype, device=counts.device)
    return (counts[:, None] == bins[None, :]).sum(dim=0).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ActStats:
    """Per-layer activation statistics (host floats)."""

    name: str = ""
    shape: tuple = ()
    numel: int = 0
    zero_frac: float = 0.0
    near_zero_frac: float = 0.0
    threshold: float = 0.0
    bz: int = DEFAULT_BZ
    block_nnz_mean: float = float("nan")  # NaN when K % bz != 0
    macs: int = 0
    absmax: float = 0.0  # max |x|: the INT8 calibration range

    @property
    def sparsity(self) -> float:
        return self.zero_frac

    @property
    def density(self) -> float:
        return 1.0 - self.zero_frac

    def __repr__(self):  # compact: shows up in logs and tables
        return (f"ActStats({self.name or '?'} {self.shape} zero={self.zero_frac:.3f}"
                f" |x|<={self.threshold:g}={self.near_zero_frac:.3f}"
                f" blk_nnz={self.block_nnz_mean:.2f}/{self.bz})")


def measure_activation(x: torch.Tensor, *, name: str = "", threshold: float = 0.0,
                       bz: int = DEFAULT_BZ, macs: int = 0) -> ActStats:
    """Measure one activation tensor: the exact zero fraction, the fraction
    with |x| <= ``threshold``, the mean non-zeros per ``bz`` block along the
    last axis and the absmax (one wait for the device)."""
    vals = [(x == 0).float().mean(), x.abs().max().float()]
    if threshold > 0:
        vals.append((x.abs() <= threshold).float().mean())
    k = x.shape[-1]
    if k % bz == 0:
        vals.append((x.reshape(*x.shape[:-1], k // bz, bz) != 0).sum(-1).float().mean())
    host = torch.stack(vals).tolist()
    zf, amax = host[0], host[1]
    nf = host[2] if threshold > 0 else zf
    return ActStats(
        name=name, shape=tuple(x.shape), numel=x.numel(), zero_frac=zf, near_zero_frac=nf,
        threshold=threshold, bz=bz, block_nnz_mean=host[-1] if k % bz == 0 else float("nan"),
        macs=int(macs), absmax=amax,
    )


def combine(stats: Sequence[ActStats], name: str = "combined") -> ActStats:
    """MAC-weighted aggregate of per-layer stats (numel-weighted when no
    MACs are given); the calibration range is a max."""
    if not stats:
        raise ValueError("combine() of empty stats")
    weights = [s.macs for s in stats]
    if not any(weights):
        weights = [s.numel for s in stats]
    total = float(sum(weights)) or 1.0

    def wavg(f):
        return sum(f(s) * w for s, w in zip(stats, weights)) / total

    bnms = [(s, w) for s, w in zip(stats, weights) if not math.isnan(s.block_nnz_mean)]
    bnm_total = float(sum(w for _, w in bnms))
    return ActStats(
        name=name, shape=(), numel=sum(s.numel for s in stats),
        zero_frac=wavg(lambda s: s.zero_frac), near_zero_frac=wavg(lambda s: s.near_zero_frac),
        threshold=stats[0].threshold, bz=stats[0].bz,
        block_nnz_mean=(sum(s.block_nnz_mean * w for s, w in bnms) / bnm_total
                        if bnms else float("nan")),
        macs=sum(s.macs for s in stats), absmax=max(s.absmax for s in stats),
    )


# ---------------------------------------------------------------------------
# Structural activation pruning (gate): the vdbb machinery on the M tile
# ---------------------------------------------------------------------------


def _act_fmt_matrix(fmt: DBBFormat) -> DBBFormat:
    """The tile-shared constraint: one pattern per K-block across the whole
    M tile (``group='matrix'`` on the transpose)."""
    return dataclasses.replace(fmt, group="matrix")


def act_dbb_mask(x: torch.Tensor, fmt: DBBFormat) -> torch.Tensor:
    """Boolean keep-mask of block-wise top-nnz activation pruning: ``x`` is
    (..., K) with blocks along K, the pattern shared across every leading
    (M) position, scored by the summed |x| over the tile (``dbb_mask`` on
    the transposed tile, ties to the lower position)."""
    k = x.shape[-1]
    mask_t = dbb_mask(x.reshape(-1, k).t(), _act_fmt_matrix(fmt))  # (K, M)
    return mask_t.t().reshape(x.shape)


def act_dbb_prune(x: torch.Tensor, fmt: DBBFormat) -> torch.Tensor:
    """Project activations onto the DBB constraint (tile-shared pattern,
    the rest zeroed). The result feeds the tc kernel unchanged: its
    compressed-K gather reads only the surviving positions."""
    if fmt.is_dense:
        return x
    return torch.where(act_dbb_mask(x, fmt), x, torch.zeros_like(x))


def act_dbb_encode(x: torch.Tensor, fmt: DBBFormat) -> DBBWeight:
    """Compress an (M, K) activation tile along K: ``dbb_encode`` of the
    transpose, one pattern across M. :func:`act_dbb_decode` of it equals
    :func:`act_dbb_prune` of the tile bit for bit."""
    if x.dim() != 2:
        raise ValueError(f"activation tile must be (M, K); got {tuple(x.shape)}")
    return dbb_encode(x.t().contiguous(), _act_fmt_matrix(fmt), prune=True)


def act_dbb_decode(ax: DBBWeight) -> torch.Tensor:
    """Expand compressed activations back to the dense (M, K) tile."""
    return dbb_decode(ax).t()


def act_fmt(stats: ActStats, bz: Optional[int] = None) -> DBBFormat:
    """The DBB bound a measured activation density supports: the smallest
    nnz whose density covers the non-zero fraction (a ceil with the
    reference's 1e-9 slack, clamped to [1, bz]), pattern-shared for the tc
    contraction. ``bz`` defaults to the block size of the stats."""
    bz = stats.bz if bz is None else bz
    nnz = math.ceil((1.0 - stats.sparsity) * bz - 1e-9)
    return DBBFormat(bz=bz, nnz=max(1, min(bz, nnz)), group="matrix")


# ---------------------------------------------------------------------------
# Collection (thread-local)
# ---------------------------------------------------------------------------


class ActCollector:
    """Accumulates :class:`ActStats` recorded during a forward pass."""

    def __init__(self, bz: int = DEFAULT_BZ, threshold: float = 0.0):
        self.bz = bz
        self.threshold = threshold
        self.stats: list[ActStats] = []

    def add(self, x: torch.Tensor, name: str = "", macs: int = 0):
        self.stats.append(measure_activation(
            x, name=name or f"act{len(self.stats)}", threshold=self.threshold, bz=self.bz,
            macs=macs))

    def combined(self, name: str = "combined") -> ActStats:
        return combine(self.stats, name)


_CTX = threading.local()


def collecting() -> bool:
    """True while a collector is installed on this thread."""
    return getattr(_CTX, "collector", None) is not None


@contextlib.contextmanager
def collect_activations(bz: int = DEFAULT_BZ, threshold: float = 0.0):
    """Install a collector so :func:`record_activation` accumulates stats;
    a nested use shadows the outer collector."""
    col = ActCollector(bz=bz, threshold=threshold)
    prev = getattr(_CTX, "collector", None)
    _CTX.collector = col
    try:
        yield col
    finally:
        _CTX.collector = prev


def record_activation(x: torch.Tensor, name: str = "", macs: int = 0):
    """Record ``x`` into the active collector; a no-op without one."""
    col: Optional[ActCollector] = getattr(_CTX, "collector", None)
    if col is not None:
        col.add(x, name=name, macs=macs)


@contextlib.contextmanager
def act_scope(name: str):
    """Push a name segment onto the thread-local scope stack, so a leaf
    recorded as ``wq`` lands as e.g. ``g0.b1.mixer.wq``."""
    stack = getattr(_CTX, "scope", None)
    if stack is None:
        stack = _CTX.scope = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def scoped(name: str = "") -> str:
    """The current dotted scope joined with ``name`` (may be empty)."""
    stack = getattr(_CTX, "scope", None) or []
    return ".".join(list(stack) + ([name] if name else []))
