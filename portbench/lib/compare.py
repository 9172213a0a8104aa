"""The numbers that decide ``correct``."""
from __future__ import annotations

import torch


def rel_max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest absolute difference over the root mean square of the
    reference: 0 for equal logits, about 1 for unrelated ones."""
    got, ref = got.double().to(ref.device), ref.double()
    rms = ref.pow(2).mean().sqrt().clamp_min(1e-30)
    return float(((got - ref).abs().amax() / rms).item())


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position: ref_logits (..., V), tokens (...)."""
    ref = ref_logits.double()
    picked = ref.gather(-1, tokens.long().to(ref.device)[..., None])[..., 0]
    return float((ref.amax(dim=-1) - picked).amax().item())
