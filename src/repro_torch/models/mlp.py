"""Dense MLP blocks (port of ``repro/models/mlp.py:DenseMLP``): SwiGLU or
GELU, with the int8-resident down projection: when ``w_down`` is quantized
and calibrated, the hidden activation is requantized once at its scale and
the int8 codes feed the down GEMM. ``MoEMLP`` is not ported.

The activations follow ``jax.nn.silu`` and ``jax.nn.gelu`` (its default
tanh approximation) op for op in the activation's dtype: XLA expands them
into elementwise ops that each round to bf16, where ``F.silu`` and
``F.gelu`` compute in fp32 and round once. In bf16 the two differ in about
40 % of the entries, by up to one ulp."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quant import quantize
from repro_torch.models.common import apply_linear, is_quantized, linear_def


def _in(dtype, value: float) -> float:
    """``value`` rounded to ``dtype``, as the reference's constants are."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def silu(x):
    """``jax.nn.silu``: x * (1 / (1 + exp(-x))), every step in x's dtype."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu(x)``: 0.5 * (1 + tanh(c * (x + k * x³))) * x with c =
    sqrt(2/π) and k = 0.044715 rounded to x's dtype, every step in it (x³
    as (x * x) * x, XLA's integer power)."""
    c, k = _in(x.dtype, float(np.sqrt(2 / np.pi))), _in(x.dtype, 0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


@dataclasses.dataclass(frozen=True)
class DenseMLP:
    cfg: "ModelConfig"  # noqa: F821

    def defs(self):
        c = self.cfg
        d = {
            "w_up": linear_def(c.d_model, c.d_ff, "embed", "mlp", dbb=c.dbb),
            "w_down": linear_def(c.d_ff, c.d_model, "mlp", "embed", dbb=c.dbb),
        }
        if c.mlp == "swiglu":
            d["w_gate"] = linear_def(c.d_model, c.d_ff, "embed", "mlp", dbb=c.dbb)
        return d

    def __call__(self, p, x):
        c = self.cfg
        up = apply_linear(x, p["w_up"], aq=p.get("w_up_aq"), name="w_up")
        if c.mlp == "swiglu":
            gate = apply_linear(x, p["w_gate"], aq=p.get("w_gate_aq"), name="w_gate")
            up = silu(gate) * up
        else:
            up = gelu(up)
        aq_down = p.get("w_down_aq")
        if is_quantized(p["w_down"]) and aq_down is not None:
            up = quantize(up, aq_down)  # int8 codes straight into the down GEMM
        y = apply_linear(up, p["w_down"], aq=aq_down, name="w_down")
        return y.to(x.dtype)


class MoEMLP:
    """Routed experts (expert-choice) with shared experts: not ported."""

    def __init__(self, cfg):
        raise NotImplementedError("MoEMLP is not ported (ROADMAP queue 1, item 12)")
