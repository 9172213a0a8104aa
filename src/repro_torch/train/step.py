"""Serving step functions (port of the serve side of
``repro/train/step.py``): ``make_prefill`` and ``make_serve_step``.
``make_train_step`` waits for the training slice (ROADMAP queue 1, item 13).

prefill:     full-sequence forward returning (last-token logits, cache); it
             hands the batch's side inputs (``memory``, ``vision_embeds``)
             to the forward.
serve_step:  one-token decode against a KV cache, on compressed (VDBB)
             weights when the model holds them; its position is a 0-d
             int64 device tensor (the reference's traced ``jnp.int32``) or
             an int. It reads tokens only: a cross block's memory K/V are
             in the cache since the prefill.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM

SIDE_INPUTS = ("memory", "vision_embeds")


def make_prefill(model: LM):
    def prefill(batch):
        side = {k: batch[k] for k in SIDE_INPUTS if k in batch}
        with torch.no_grad():
            logits, cache = model.forward(batch["tokens"], return_cache=True, **side)
        return logits[:, -1:, :], cache

    return prefill


def make_serve_step(model: LM):
    def serve_step(cache, batch, pos):
        with torch.no_grad():
            return model.decode_step(cache, batch["tokens"], pos)

    return serve_step
