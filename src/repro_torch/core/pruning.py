"""Training-time DBB pruning over whole models and parameter trees (port of
``repro/core/pruning.py``).

The paper's recipe (§V-A): start from a dense model, apply magnitude-based
DBB-aware pruning progressively, then fine-tune with the mask fixed. Here
that is a projection applied after each optimizer update, driven by a
:class:`~repro_torch.core.sparse_linear.PruneSchedule`: ``LM.constrain`` for
the LM's tree, :func:`make_constrain_fn` for a list of layers. The port's
layers hold their own weights, so where the reference threads each layer's
sub-tree through a getter and a setter, the port projects each layer in
place.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from repro_torch.core.sparse_linear import PruneSchedule
from repro_torch.core.vdbb import DBBFormat, dbb_prune, satisfies_dbb


def global_dbb_stats(params, fmts: dict) -> dict:
    """Density and constraint satisfaction per tagged leaf. ``fmts``:
    ``{path: (DBBFormat, leaf)}``; ``params`` is not read (the reference's
    signature)."""
    out = {}
    for path, (fmt, w) in fmts.items():
        out[path] = dict(density=float((w != 0).float().mean()), target_density=fmt.density,
                         satisfied=bool(satisfies_dbb(w, fmt)))
    return out


def make_constrain_fn(layers: Iterable, schedule: Optional[PruneSchedule] = None) -> Callable:
    """``f(step=None)`` projecting every layer's dense weight (a
    ``DBBLinear`` or ``DBBConv2d``) onto its constraint in place, annealed
    by ``schedule`` at ``step``."""
    layers = list(layers)

    def constrain(step=None):
        for m in layers:
            m.constrain(step, schedule)

    return constrain


def prune_tree_to_dbb(params, fmt: DBBFormat, min_k: Optional[int] = None):
    """Blanket-prune every rank-2 tensor of a nested-dict tree whose K is
    blockable (and at least ``min_k``): a utility for experiments; models
    use per-layer formats."""
    if isinstance(params, dict):
        return {k: prune_tree_to_dbb(v, fmt, min_k) for k, v in params.items()}
    if (isinstance(params, torch.Tensor) and params.dim() == 2
            and params.shape[0] % fmt.bz == 0 and (min_k is None or params.shape[0] >= min_k)):
        return dbb_prune(params, fmt)
    return params
