"""The assigned input-shape sets and LM input batches (port of
``repro/configs/shapes.py``).

Every LM arch is paired with four shapes: ``decode_*`` and ``long_*`` run
the serve step (one new token against a cache of ``seq_len``), ``train_4k``
the train step and ``prefill_32k`` the prefill forward. :func:`input_specs`
gives each cell's inputs as ``meta`` tensors (shapes and dtypes, nothing
allocated), :func:`make_batch` concrete ones: tokens, and the modality
frontends' stub inputs, which the reference feeds as precomputed encoder
outputs (the vision tower's patch embeddings and the text encoder's memory
for cross-attention)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def cell_runnable(cfg: ModelConfig, shape_name: str) -> tuple:
    """(runnable, reason). long_500k only for bounded-state archs."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k-token dense KV cache is the "
                       "quadratic-regime artifact this shape excludes (DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    if cfg.frontend == "audio":
        return _meta((b, s, cfg.num_codebooks), torch.int32)
    return _meta((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` tensors standing in for every model input of this cell, in
    the reference's shapes and dtypes."""
    sh = SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    if kind == "decode":  # one new token against a cache of seq_len
        batch = {"tokens": _tok_spec(cfg, b, 1)}
        if cfg.cross_attn:
            batch["memory"] = _meta((b, cfg.cross_len, cfg.d_model), torch.bfloat16)
        return batch
    batch = {"tokens": _tok_spec(cfg, b, s)}
    if kind == "train":
        batch["labels"] = _tok_spec(cfg, b, s)
        batch["loss_mask"] = _meta((b, s), torch.float32)
    if cfg.frontend == "vision":
        batch["vision_embeds"] = _meta((b, cfg.num_vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.cross_attn:
        batch["memory"] = _meta((b, cfg.cross_len, cfg.d_model), torch.bfloat16)
    return batch


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
