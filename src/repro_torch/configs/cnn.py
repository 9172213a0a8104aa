"""CNN inference configs (port of ``repro/configs/cnn.py``).

``sparsity`` maps to the paper's nominal formats: 0.625 -> 3/8 DBB.
``pattern='matrix'`` (one pattern shared across N, the tc kernels) is the
default; ``pattern=None`` gives per-column patterns (bw).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.vdbb import DBBFormat
from repro_torch.models.cnn import CNNConfig


def _dbb(sparsity: Optional[Union[str, float]], pattern="matrix") -> Optional[DBBFormat]:
    if sparsity in (None, "dense", 0.0):
        return None
    if isinstance(sparsity, str):
        sparsity = float(sparsity)
    nnz = max(1, min(8, round((1.0 - sparsity) * 8)))
    return DBBFormat(8, nnz, pattern)


def sparse_cnn_tiny(sparsity=0.625, pattern="matrix") -> CNNConfig:
    """CIFAR-scale smoke model: 6 convs, 32×32×3 input."""
    return CNNConfig(
        name="sparse-cnn-tiny", in_channels=3, image_size=32,
        stage_channels=(32, 64, 128), convs_per_stage=2, num_classes=10,
        dbb=_dbb(sparsity, pattern),
    )


def sparse_cnn_s(sparsity=0.625, pattern="matrix") -> CNNConfig:
    """ImageNet-tile-scale: 8 convs, 64×64×3 input, VGG-ish widths."""
    return CNNConfig(
        name="sparse-cnn-s", in_channels=3, image_size=64,
        stage_channels=(64, 128, 256, 512), convs_per_stage=2, num_classes=1000,
        dbb=_dbb(sparsity, pattern),
    )


CNN_ARCHS = {
    "sparse-cnn-tiny": sparse_cnn_tiny,
    "sparse-cnn-s": sparse_cnn_s,
}


def get_cnn_config(name: str, sparsity=0.625, pattern="matrix") -> CNNConfig:
    return CNN_ARCHS[name](sparsity=sparsity, pattern=pattern)


def smoke_cnn_config(name: str, sparsity=0.625, pattern="matrix") -> CNNConfig:
    """Reduced CPU-runnable variant of the same family."""
    cfg = get_cnn_config(name, sparsity=sparsity, pattern=pattern)
    return dataclasses.replace(
        cfg, image_size=16, stage_channels=tuple(cfg.stage_channels[:2]),
        convs_per_stage=1, num_classes=min(cfg.num_classes, 10),
    )
