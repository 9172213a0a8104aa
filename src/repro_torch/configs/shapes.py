"""Concrete LM input batches (port of ``repro/configs/shapes.py:make_batch``):
token batches only; the modality frontends' inputs are not ported."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig


def make_batch(cfg: ModelConfig, *, batch: int, seq: int,
               generator: Optional[torch.Generator] = None, kind: str = "serve",
               device=None) -> dict:
    """``{"tokens": (batch, seq) int32}`` drawn uniformly from the vocabulary
    with ``generator`` (on the generator's device, then moved to
    ``device``); a ``kind='train'`` batch adds ``labels`` and ``loss_mask``."""
    if cfg.frontend is not None or cfg.cross_attn:
        raise NotImplementedError(
            f"{cfg.name}: frontend/cross-attention inputs are not ported (ROADMAP queue 1)")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = gen.device if device is None else torch.device(device)

    def draw():
        t = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=gen.device)
        return t.to(device=dev, dtype=torch.int32)

    out = {"tokens": draw()}
    if kind == "train":
        out["labels"] = draw()
        out["loss_mask"] = torch.ones((batch, seq), dtype=torch.float32, device=dev)
    return out
