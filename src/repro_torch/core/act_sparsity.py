"""Activation statistics and their collection (port of
``repro/core/act_sparsity.py``: ``ActStats``, ``measure_activation``,
``combine``, and the thread-local collector with its hierarchical names).

``measure_activation`` gives the zero fraction and the ``absmax`` that
``quant.act_scale_from_stats`` turns into a static scale. While a collector
is installed (:func:`collect_activations`, ``LM.forward(...,
collect_act_stats=True)``) every :func:`record_activation` lands in it under
the current :func:`act_scope` path, e.g. ``g0.b1.mixer.wq``: the address
``LM.quantize`` looks a layer's calibrated scale up by.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence

import torch

from repro_torch.core.vdbb import DEFAULT_BZ


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
