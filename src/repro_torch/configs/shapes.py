"""Concrete LM input batches (port of ``repro/configs/shapes.py:make_batch``):
tokens, and the modality frontends' stub inputs, which the reference feeds
as precomputed encoder outputs: the vision tower's patch embeddings and the
text encoder's memory for cross-attention."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig


def make_batch(cfg: ModelConfig, *, batch: int, seq: int,
               generator: Optional[torch.Generator] = None, kind: str = "serve",
               device=None) -> dict:
    """``{"tokens"}`` drawn uniformly from the vocabulary with ``generator``
    (on the generator's device, then moved to ``device``): (batch, seq)
    int32, or (batch, seq, num_codebooks) from ``codebook_vocab`` for an
    audio model. A ``kind='train'`` batch adds ``labels`` and ``loss_mask``.
    As the reference: a vision model gets ``vision_embeds`` (batch,
    num_vision_tokens, d_model) only when ``seq`` exceeds
    ``num_vision_tokens``, a cross-attention model ``memory`` (batch,
    cross_len, d_model); both 0.02 · N(0, 1), drawn in fp32 and rounded
    to bf16."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = gen.device if device is None else torch.device(device)
    audio = cfg.frontend == "audio"
    vocab = cfg.codebook_vocab if audio else cfg.vocab_size
    shape = (batch, seq, cfg.num_codebooks) if audio else (batch, seq)

    def draw():
        t = torch.randint(0, vocab, shape, generator=gen, device=gen.device)
        return t.to(device=dev, dtype=torch.int32)

    def embeds(rows):
        x = torch.randn((batch, rows, cfg.d_model), generator=gen, device=gen.device)
        return (0.02 * x).to(device=dev, dtype=torch.bfloat16)

    out = {"tokens": draw()}
    if kind == "train":
        out["labels"] = draw()
        out["loss_mask"] = torch.ones((batch, seq), dtype=torch.float32, device=dev)
    if cfg.frontend == "vision" and seq > cfg.num_vision_tokens:
        out["vision_embeds"] = embeds(cfg.num_vision_tokens)
    if cfg.cross_attn:
        out["memory"] = embeds(cfg.cross_len)
    return out
