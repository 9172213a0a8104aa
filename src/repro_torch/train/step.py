"""Serving step functions (port of the serve side of
``repro/train/step.py``): ``make_prefill`` and ``make_serve_step``.
``make_train_step`` waits for the training slice (ROADMAP queue 1, item 13).

prefill:     full-sequence forward returning (last-token logits, cache).
serve_step:  one-token decode against a KV cache, on compressed (VDBB)
             weights when the model holds them; its position is a 0-d
             int64 device tensor (the reference's traced ``jnp.int32``) or
             an int.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM


def make_prefill(model: LM):
    def prefill(batch):
        with torch.no_grad():
            logits, cache = model.forward(batch["tokens"], return_cache=True)
        return logits[:, -1:, :], cache

    return prefill


def make_serve_step(model: LM):
    def serve_step(cache, batch, pos):
        with torch.no_grad():
            return model.decode_step(cache, batch["tokens"], pos)

    return serve_step
