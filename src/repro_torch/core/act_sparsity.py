"""Activation statistics for INT8 calibration (port of the ``ActStats``
part of ``repro/core/act_sparsity.py``): the zero fraction and the
``absmax`` that ``quant.act_scale_from_stats`` turns into a static scale."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.vdbb import DEFAULT_BZ


@dataclasses.dataclass(frozen=True)
class ActStats:
    """Per-layer activation statistics (host floats)."""

    name: str = ""
    shape: tuple = ()
    numel: int = 0
    zero_frac: float = 0.0
    bz: int = DEFAULT_BZ
    macs: int = 0
    absmax: float = 0.0  # max |x|: the INT8 calibration range

    @property
    def sparsity(self) -> float:
        return self.zero_frac

    @property
    def density(self) -> float:
        return 1.0 - self.zero_frac


def measure_activation(x: torch.Tensor, *, name: str = "", macs: int = 0) -> ActStats:
    """Measure one activation tensor (waits for the device)."""
    return ActStats(
        name=name, shape=tuple(x.shape), numel=x.numel(),
        zero_frac=float((x == 0).float().mean()), macs=int(macs),
        absmax=float(x.abs().max()),
    )
