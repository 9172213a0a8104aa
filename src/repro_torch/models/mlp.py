"""MLP blocks (port of ``repro/models/mlp.py``): ``DenseMLP`` (SwiGLU or
GELU, with the int8-resident down projection: when ``w_down`` is quantized
and calibrated, the hidden activation is requantized once at its scale and
the int8 codes feed the down GEMM) and ``MoEMLP`` (expert-choice routed
experts with fused shared experts).

The activations follow ``jax.nn.sigmoid``, ``silu`` and ``gelu`` (its default
tanh approximation) op for op in the activation's dtype: XLA expands them
into elementwise ops that each round to bf16, where ``F.silu`` and
``F.gelu`` compute in fp32 and round once. In bf16 the two differ in about
40 % of the entries, by up to one ulp."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.act_sparsity import act_scope
from repro_torch.core.quant import quantize
from repro_torch.models.common import Param, apply_linear, is_quantized, linear_def


def _in(dtype, value: float) -> float:
    """``value`` rounded to ``dtype``, as the reference's constants are."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def sigmoid(x):
    """``jax.nn.sigmoid`` (XLA's logistic): 1 / (1 + exp(-x)), every step in
    x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), every step in x's dtype."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu(x)``: 0.5 * (1 + tanh(c * (x + k * x³))) * x with c =
    sqrt(2/π) and k = 0.044715 rounded to x's dtype, every step in it (x³
    as (x * x) * x, XLA's integer power)."""
    c, k = _in(x.dtype, float(np.sqrt(2 / np.pi))), _in(x.dtype, 0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


@dataclasses.dataclass(frozen=True)
class DenseMLP:
    cfg: "ModelConfig"  # noqa: F821
    d_ff: int = 0  # override (shared experts); 0 -> cfg.d_ff

    @property
    def ff(self):
        return self.d_ff or self.cfg.d_ff

    def defs(self):
        c = self.cfg
        d = {
            "w_up": linear_def(c.d_model, self.ff, "embed", "mlp", dbb=c.dbb),
            "w_down": linear_def(self.ff, c.d_model, "mlp", "embed", dbb=c.dbb),
        }
        if c.mlp == "swiglu":
            d["w_gate"] = linear_def(c.d_model, self.ff, "embed", "mlp", dbb=c.dbb)
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


def top_cap(scores, cap: int):
    """``jax.lax.top_k(scores, cap)`` along the last axis: the ``cap``
    largest values and their indices, the lower index first among equal
    values, as the reference's. A stable descending sort gives that order;
    ``torch.topk`` on a card promises none among ties, and tokens that are
    the same at the same position tie at decode."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :cap], idx[..., :cap]


def combine(out, idx, n: int):
    """The experts' rows summed back to their tokens: ``out`` (..., E, cap,
    d), ``idx`` (..., E, cap) token indices in [0, n) -> (..., n, d).

    The reference scatter-adds all of them at once (``y.at[idx].add(out)``),
    which XLA runs in update order, expert by expert, rounding after each
    add. Here that order is explicit: one ``index_add_`` per expert, in
    expert order. An expert's indices are distinct (its top ``cap`` tokens
    of each example), so no two adds of one call meet: no atomics race, a
    CUDA graph's replay and an eager call give the same bits, and every add
    rounds where the reference's does. A NaN row stays in its own token."""
    *lead, e, cap, d = out.shape
    groups = math.prod(lead)
    out = out.reshape(groups, e, cap, d)
    rows = idx.reshape(groups, e, cap) + n * torch.arange(groups, device=idx.device)[:, None, None]
    y = out.new_zeros(groups * n, d)
    for i in range(e):
        y.index_add_(0, rows[:, i].reshape(-1), out[:, i].reshape(-1, d))
    return y.reshape(*lead, n, d)


@dataclasses.dataclass(frozen=True)
class MoEMLP:
    """Routed experts (expert-choice) + optional fused shared experts.

    Experts pick their top-``cap`` tokens: within each example at prefill
    (``_grouped``), over the batch's tokens at decode (``_global``), with
    ``cap`` from the token count, ``top_k`` and the capacity factor as the
    reference computes it. The router runs in fp32; the expert stacks
    (E, d, f) are bf16 batched products (the reference's ``einsum``s,
    outside any Pallas kernel), never compressed; the shared experts are
    one ``DenseMLP`` of ``num_shared_experts * d_ff`` on the VDBB datapath."""

    cfg: "ModelConfig"  # noqa: F821

    def _shared(self) -> DenseMLP:
        c = self.cfg
        return DenseMLP(c, d_ff=c.num_shared_experts * c.d_ff)

    def defs(self):
        c = self.cfg
        e, dm, ff = c.num_experts, c.d_model, c.d_ff
        d = {
            "router": linear_def(dm, e, "embed", None, scale=1.0),
            "we_gate": Param((e, dm, ff), ("experts", "w_embed", None), "scaled"),
            "we_up": Param((e, dm, ff), ("experts", "w_embed", None), "scaled"),
            "we_down": Param((e, ff, dm), ("experts", None, "w_embed"), "scaled"),
        }
        if c.num_shared_experts:
            d["shared"] = self._shared().defs()
        return d

    def __call__(self, p, x):
        _, s, _ = x.shape
        y = self._grouped(p, x) if s > 1 else self._global(p, x)  # decode: a few tokens
        if self.cfg.num_shared_experts:
            with act_scope("shared"):
                y = y + self._shared()(p["shared"], x)
        return y

    def _probs(self, p, x):
        """The router's fp32 probabilities over the experts."""
        return torch.softmax(apply_linear(x.float(), p["router"].float()), dim=-1)

    def _experts(self, p, disp):
        """Each expert's SwiGLU over its dispatched rows: (E, rows, d) in the
        activation dtype -> (E, rows, d)."""
        dt = disp.dtype
        h = torch.bmm(disp, p["we_up"].to(dt))
        g = torch.bmm(disp, p["we_gate"].to(dt))
        return torch.bmm(silu(g) * h, p["we_down"].to(dt))

    def _grouped(self, p, x):
        """GShard-style grouped expert choice: experts pick their top-``cap``
        tokens within each example."""
        c = self.cfg
        b, s, dm = x.shape
        e = c.num_experts
        cap = max(1, int(s * c.top_k * c.moe_capacity_factor) // e)
        gates, idx = top_cap(self._probs(p, x).transpose(1, 2), cap)  # (b, E, cap)
        disp = x[torch.arange(b, device=x.device)[:, None, None], idx]  # (b, E, cap, d)
        out = self._experts(p, disp.transpose(0, 1).reshape(e, b * cap, dm))
        out = out.reshape(e, b, cap, dm).transpose(0, 1) * gates[..., None].to(x.dtype)
        return combine(out, idx, s)

    def _global(self, p, x):
        """Expert choice over all the batch's tokens (decode)."""
        c = self.cfg
        b, s, dm = x.shape
        t, e = b * s, c.num_experts
        xf = x.reshape(t, dm)
        cap = max(1, int(t * c.top_k * c.moe_capacity_factor) // e)
        gates, idx = top_cap(self._probs(p, xf).T, cap)  # (E, cap)
        disp = xf.index_select(0, idx.reshape(-1)).reshape(e, cap, dm)
        out = self._experts(p, disp) * gates[..., None].to(x.dtype)
        return combine(out, idx, t).reshape(b, s, dm)

    def aux_loss(self, p, x):
        """Load-balance (importance) auxiliary loss ``E · Σ_e frac_e²``,
        ``frac_e`` expert e's mean routing probability over the batch: 1.0
        for a perfectly uniform router."""
        probs = self._probs(p, x.reshape(-1, x.shape[-1]))
        frac = probs.mean(0)
        return (frac * frac).sum() * probs.shape[-1]
