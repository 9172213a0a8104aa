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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.act_sparsity import act_scope
from repro_torch.core.quant import quantize
from repro_torch.models.common import (Param, apply_linear, current_rules, is_quantized,
                                       linear_def, shard, spec_placements)


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
        up = shard(up, ("batch", None, "mlp"))
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


_STACKS = ("we_gate", "we_up", "we_down")


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
        y = self._routed(p, x, grouped=s > 1)  # decode: a few tokens, routed over the batch
        if self.cfg.num_shared_experts:
            with act_scope("shared"):
                y = y + self._shared()(p["shared"], x)
        return shard(y, ("batch", "seq", "embed"))

    def _probs(self, p, x):
        """The router's fp32 probabilities over the experts."""
        return torch.softmax(apply_linear(x.float(), p["router"].float()), dim=-1)

    def _experts(self, p, disp):
        """Each expert's SwiGLU over its dispatched rows: (E, rows, d) in the
        activation dtype -> (E, rows, d), E the stacks' experts in ``p``."""
        dt = disp.dtype
        h = torch.bmm(disp, p["we_up"].to(dt))
        g = torch.bmm(disp, p["we_gate"].to(dt))
        return torch.bmm(silu(g) * h, p["we_down"].to(dt))

    def _routed(self, p, x, *, grouped: bool):
        """The routed experts' output: :meth:`_grouped` (prefill and train)
        or :meth:`_global` (decode).

        On one device the body runs on the tensors as they are (``e0`` = 0,
        every expert). On a mesh it runs under ``local_map``, the reference's
        layout: each rank takes its rows (``_grouped``: its batch shard,
        with the sequence gathered, as ``shard(x, ("batch", None,
        "embed"))``; ``_global``: every token of the batch, which expert
        choice over the batch needs), runs the router and ``top_cap`` on
        them, keeps the indices and gates of its own experts (the stacks'
        'experts' shards), dispatches locally, runs its expert stacks (the
        FSDP-sharded ``w_embed`` dim gathered for the product, as
        ``common._dense_sharded_linear`` gathers a dense weight) and combines
        them in expert order into a partial sum over the expert shards,
        which the closing :func:`shard` reduce-scatters. Gradients: the
        rows' a partial sum over the expert shards; the expert stacks' a
        partial sum over the batch shards; the router's over both."""
        body = self._grouped if grouped else self._global
        keys = ("router",) + _STACKS
        if not isinstance(x, DTensor):
            return body(p, x)
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        batch = current_rules().get("batch") if grouped else None
        x_in = spec_placements((batch, None, None), mesh, x.shape, uneven="replicate")
        split = [j for j, pl in enumerate(p["we_up"].placements) if pl == Shard(0)]
        if any(isinstance(x_in[j], Shard) for j in split):
            raise ValueError("a mesh dim splits both the experts and the batch")
        lead = [j for j, pl in enumerate(x_in) if isinstance(pl, Shard)]
        part = [Partial() if j in split else pl for j, pl in enumerate(x_in)]
        w_in = [Shard(0) if j in split else Replicate() for j in range(mesh.ndim)]
        w_grad = [Partial() if j in lead else pl for j, pl in enumerate(w_in)]
        r_in = [Replicate()] * mesh.ndim
        r_grad = [Partial() if j in lead or j in split else Replicate()
                  for j in range(mesh.ndim)]

        def local(xl, *ws):
            e0 = 0
            for j in split:  # the experts' shards, major to minor in mesh order
                e0 = e0 * mesh.size(j) + mesh.get_local_rank(j)
            return body(dict(zip(keys, ws)), xl, e0 * ws[1].shape[0])

        w_pl = (tuple(w_in),) * len(_STACKS)
        fn = local_map(local, out_placements=(tuple(part),),
                       in_placements=(tuple(x_in), tuple(r_in)) + w_pl,
                       in_grad_placements=(tuple(part), tuple(r_grad)) + (tuple(w_grad),) * 3,
                       device_mesh=mesh, redistribute_inputs=True)
        return fn(x, *(p[k] for k in keys))

    def _grouped(self, p, x, e0: int = 0):
        """GShard-style grouped expert choice: experts pick their top-``cap``
        tokens within each example. ``p``'s stacks hold experts ``e0`` …
        ``e0 + E_local - 1``; the other experts' picks are not this call's."""
        c = self.cfg
        b, s, dm = x.shape
        el = p["we_up"].shape[0]
        cap = max(1, int(s * c.top_k * c.moe_capacity_factor) // c.num_experts)
        gates, idx = top_cap(self._probs(p, x).transpose(1, 2), cap)  # (b, E, cap)
        gates, idx = gates[:, e0: e0 + el], idx[:, e0: e0 + el]
        disp = x[torch.arange(b, device=x.device)[:, None, None], idx]  # (b, el, cap, d)
        out = self._experts(p, disp.transpose(0, 1).reshape(el, b * cap, dm))
        out = out.reshape(el, b, cap, dm).transpose(0, 1) * gates[..., None].to(x.dtype)
        return combine(out, idx, s)

    def _global(self, p, x, e0: int = 0):
        """Expert choice over all the batch's tokens (decode); ``p`` and
        ``e0`` as :meth:`_grouped`'s."""
        c = self.cfg
        b, s, dm = x.shape
        t, el = b * s, p["we_up"].shape[0]
        xf = x.reshape(t, dm)
        cap = max(1, int(t * c.top_k * c.moe_capacity_factor) // c.num_experts)
        gates, idx = top_cap(self._probs(p, xf).T, cap)  # (E, cap)
        gates, idx = gates[e0: e0 + el], idx[e0: e0 + el]
        disp = xf.index_select(0, idx.reshape(-1)).reshape(el, cap, dm)
        out = self._experts(p, disp) * gates[..., None].to(x.dtype)
        return combine(out, idx, t).reshape(b, s, dm)

    def aux_loss(self, p, x):
        """Load-balance (importance) auxiliary loss ``E · Σ_e frac_e²``,
        ``frac_e`` expert e's mean routing probability over the batch: 1.0
        for a perfectly uniform router."""
        probs = self._probs(p, x.reshape(-1, x.shape[-1]))
        frac = probs.mean(0)
        return (frac * frac).sum() * probs.shape[-1]
