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


def resnet50_v1_5(sparsity=0.625, pattern="matrix") -> CNNConfig:
    """ResNet-50 v1.5 at its published widths (torchvision's ``resnet50``;
    He et al., arXiv:1512.03385, with the stride on the 3 × 3 conv): a 7 × 7
    stride-2 stem to 64 channels, a 3 × 3 stride-2 max-pool, (3, 4, 6, 3)
    bottleneck blocks of inner widths 64 / 128 / 256 / 512 (expansion 4),
    an FC 2048 → 1000 head; 224 × 224 × 3 input. Batch norm is folded into
    each conv's weight and bias, as at inference. Every conv but the
    C = 3 stem, and the head, is DBB-compressed (the paper's technique)."""
    return CNNConfig(
        name="resnet50-v1.5", in_channels=3, image_size=224, block="bottleneck",
        stem_channels=64, stem_kernel=7, stem_stride=2, max_pool=(3, 2, 1),
        stage_channels=(64, 128, 256, 512), blocks_per_stage=(3, 4, 6, 3), expansion=4,
        num_classes=1000, dbb=_dbb(sparsity, pattern),
    )


CNN_ARCHS = {
    "sparse-cnn-tiny": sparse_cnn_tiny,
    "sparse-cnn-s": sparse_cnn_s,
    "resnet50-v1.5": resnet50_v1_5,
}


def get_cnn_config(name: str, sparsity=0.625, pattern="matrix") -> CNNConfig:
    return CNN_ARCHS[name](sparsity=sparsity, pattern=pattern)


def smoke_cnn_config(name: str, sparsity=0.625, pattern="matrix") -> CNNConfig:
    """Reduced CPU-runnable variant of the same family (a bottleneck layout:
    every width ÷ 8, one block a stage, 32 × 32 input, 10 classes)."""
    cfg = get_cnn_config(name, sparsity=sparsity, pattern=pattern)
    if cfg.block == "bottleneck":
        return dataclasses.replace(
            cfg, image_size=32, stem_channels=cfg.stem_channels // 8,
            stage_channels=tuple(c // 8 for c in cfg.stage_channels),
            blocks_per_stage=(1,) * len(cfg.stage_channels), num_classes=min(cfg.num_classes, 10))
    return dataclasses.replace(
        cfg, image_size=16, stage_channels=tuple(cfg.stage_channels[:2]),
        convs_per_stage=1, num_classes=min(cfg.num_classes, 10),
    )
