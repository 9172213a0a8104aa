"""Step functions (port of ``repro/train/step.py``).

train_step:  loss -> gradients -> AdamW -> DBB constraint projection (the
             paper's magnitude pruning, applied as projected SGD), eagerly:
             the reference's ``jax.jit`` has no counterpart here.
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

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten, full_tensor
from repro_torch.core.sparse_linear import PruneSchedule
from repro_torch.models.model import LM
from repro_torch.optim.adamw import OptConfig, apply_updates

SIDE_INPUTS = ("memory", "vision_embeds")


def to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: integer arrays
    (tokens, labels) as int64, floating ones (``loss_mask``, ``memory``,
    ``vision_embeds``) in their own float dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, torch.int64 if not t.is_floating_point() else t.dtype)
    return out


def make_train_step(model: LM, opt_cfg: OptConfig, schedule: Optional[PruneSchedule] = None,
                    *, mark: Optional[Callable[[str], None]] = None):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` on the model's tree (``params`` is adopted as it when it is
    another), updated in place: the loss and its gradients by autograd,
    ``apply_updates``, then ``model.constrain(step, schedule)`` when the
    config carries a DBB format. ``metrics``: ``loss``, ``nll_mean`` and
    ``grad_norm`` (0-d tensors on the device), ``lr`` and ``step``. ``mark``
    (optional) is called with ``"backward"``, ``"update"`` and
    ``"constrain"`` as each part ends, for a caller that times them."""
    def note(name):
        if mark is not None:
            mark(name)

    def train_step(params, opt_state, batch: dict, step: int):
        if params is not model.params:
            model.load_params(params)
        leaves = flatten(model.params)[0]
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        note("backward")
        _, opt_state, opt_metrics = apply_updates(model.params, list(grads), opt_state, step,
                                                  opt_cfg)
        del grads
        note("update")
        if model.cfg.dbb is not None:
            model.constrain(step, schedule)
        note("constrain")
        metrics = {k: full_tensor(v.detach()) for k, v in metrics.items()}
        return model.params, opt_state, {**metrics, **opt_metrics, "step": step}

    return train_step


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
