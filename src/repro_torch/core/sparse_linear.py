"""DBBLinear — the VDBB layer as a fully connected layer (port of
``repro/core/sparse_linear.py``).

A layer is an ``nn.Module`` whose state carries the reference's leaf names:
``w`` (a dense tensor, a :class:`DBBWeight` or a :class:`QuantDBBWeight`),
``b`` and the calibrated activation scale ``aq`` (and, on a ResNet
projection shortcut only, ``oq``, its output codes' scale). :meth:`compress` and
:meth:`quantize` convert that state **in place**. Whether a product runs the
CUDA kernel or its plain version follows the tensors' device; unlike the TPU
reference there is no tiny-M fallback: the head runs its kernel at any M
(integer accumulation is exact and the epilogue is the same, so the result
does not change).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.quant import QuantDBBWeight, quantize, quantize_dbb
from repro_torch.core.vdbb import DBBFormat, DBBWeight, DENSE, dbb_encode, dbb_prune
from repro_torch.kernels import ops

# ``oq``: the scale a layer's int8 output codes are held at, where that is
# the layer's own (a ResNet projection shortcut's, calibrated on its output);
# absent from every other layer's state
STATE_KEYS = ("w", "b", "aq", "oq")


def trunc_normal(shape, generator, scale: float) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [-2, 2], drawn on the CPU
    from ``generator`` (so a seed gives the same weights on every device)."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * scale


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    """Linear anneal of nnz from bz to the target between ``begin_step`` and
    ``end_step`` (the paper's progressive DBB pruning). The projection runs
    after every step; the reference's ``constrain_every`` field, which nothing
    reads, is not kept."""

    begin_step: int = 0
    end_step: int = 1

    def nnz_at(self, step: int, fmt: DBBFormat) -> int:
        """The density bound at ``step``, a host int. Computed in float32 and
        rounded half to even, as the reference's traced ``jnp`` arithmetic
        does (a half-way step rounds to the even nnz)."""
        f32 = np.float32
        frac = f32(step - self.begin_step) / f32(max(self.end_step - self.begin_step, 1))
        frac = np.clip(frac, f32(0.0), f32(1.0))
        return int(np.round(f32(fmt.bz) - frac * f32(fmt.bz - fmt.nnz)))


def scheduled_fmt(fmt: DBBFormat, step=None, schedule: Optional[PruneSchedule] = None
                  ) -> DBBFormat:
    """The format a constraint projects onto: ``fmt``, or with a schedule
    and a step its annealed bound ``schedule.nnz_at(step)``."""
    if schedule is None or step is None:
        return fmt
    return dataclasses.replace(fmt, nnz=schedule.nnz_at(step, fmt))


class DBBLayer(nn.Module):
    """State handling shared by :class:`DBBLinear` and ``DBBConv2d``."""

    def __init__(self, fmt: DBBFormat, use_bias: bool):
        super().__init__()
        self.fmt, self.use_bias = fmt, use_bias
        for k in STATE_KEYS:
            self.register_buffer(k, None)

    def put(self, name: str, value) -> None:
        """Set one state entry: a tensor becomes a buffer, a compressed
        weight a plain attribute."""
        if name not in STATE_KEYS:
            raise KeyError(f"unknown state entry {name!r}")
        self._buffers.pop(name, None)
        self.__dict__.pop(name, None)
        if value is None or isinstance(value, torch.Tensor):
            self.register_buffer(name, value)
        else:
            object.__setattr__(self, name, value)

    def state(self) -> dict:
        """The reference's parameter leaves of this layer."""
        return {k: getattr(self, k) for k in STATE_KEYS if getattr(self, k) is not None}

    def load_state(self, state: dict) -> None:
        for k in STATE_KEYS:
            self.put(k, state.get(k))

    def _init_bias(self, n: int, device) -> None:
        if self.use_bias:
            self.put("b", torch.zeros(n, dtype=torch.float32, device=device))

    def quantize(self, act_scale=None) -> None:
        """In place: int8 values + per-channel scales for a compressed
        weight, and the static activation scale ``aq`` when given. A dense
        weight (the stem) stays fp32; an int8 weight is only re-calibrated."""
        w = self.w
        if isinstance(w, DBBWeight):
            self.put("w", quantize_dbb(w))
        elif not isinstance(w, QuantDBBWeight):
            return
        if act_scale is not None:
            self.put("aq", torch.tensor(act_scale, dtype=torch.float32, device=w.device))


class DBBLinear(DBBLayer):
    """y = x @ W (+ b); W is (in_features, out_features), DBB along K."""

    def __init__(self, in_features: int, out_features: int, fmt: DBBFormat = DENSE,
                 use_bias: bool = False):
        super().__init__(fmt, use_bias)
        self.in_features, self.out_features = in_features, out_features

    def init(self, generator: torch.Generator, device) -> None:
        w = trunc_normal((self.in_features, self.out_features), generator,
                         1.0 / self.in_features**0.5).to(device)
        if not self.fmt.is_dense:
            w = dbb_prune(w, self.fmt)
        self.put("w", w)
        self._init_bias(self.out_features, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._linear(x, self.w, self.b, self.aq)

    def _linear(self, x, w, b, aq, choice=None):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if isinstance(w, QuantDBBWeight):
            y = ops.quant_matmul(x2, w, aq, choice=choice)
        elif isinstance(w, DBBWeight):
            y = ops.vdbb_matmul(x2, w, choice=choice)
        else:
            y = x2 @ w.to(x.dtype)
        if self.use_bias:
            y = y + b.to(y.dtype)
        return y.reshape(*lead, self.out_features)

    def make_plan(self, *, batch: int, relu: bool = False, out_scale=None,
                  fused: bool = False, tune: str = "cache", cache=None, top_k: int = 4,
                  reps: int = 3, choice=None):
        """Stage this layer's serving step once for ``batch`` rows; the GEMM
        twin of ``DBBConv2d.make_plan``. The launch choice of a compressed
        weight is ``choice`` when given, else resolved here under ``tune``
        (``autotune.tiles_for_matmul``: the registry, then ``cache``, then a
        search for ``'search'``; the rule's otherwise, and always on the
        CPU), and frozen into the stage.
        Returns ``(run, tiles)``: with ``fused`` and a quantized weight,
        :meth:`quant_serve` staged through ``ops.stage_quant_matmul`` (tiles:
        the int8 tile plan); otherwise the per-layer product (+ bias), then
        ReLU and a requantize at ``out_scale`` when asked (tiles: a tuned
        choice, if any)."""
        from repro_torch.kernels import autotune

        wt, b, aq = self.w, self.b, self.aq
        if choice is not None:
            autotune.check_mode(tune)
        elif isinstance(wt, (DBBWeight, QuantDBBWeight)):
            dtype = torch.int8 if isinstance(wt, QuantDBBWeight) else wt.values.dtype
            choice = autotune.tiles_for_matmul(
                batch, self.in_features, self.out_features, wt.fmt, dtype, mode=tune,
                cache=cache, top_k=top_k, reps=reps, device=wt.values.device)
        else:
            autotune.check_mode(tune)
            choice = {}
        if fused and isinstance(wt, QuantDBBWeight):
            return ops.stage_quant_matmul(wt, aq, batch, bias=b, relu=relu, out_scale=out_scale,
                                          choice=choice)

        def run(x):
            y = self._linear(x, wt, b, aq, choice)
            if relu:
                y = torch.relu(y)
            return y if out_scale is None else quantize(y, out_scale)

        return run, dict(choice)

    def quant_serve(self, x: torch.Tensor, *, relu: bool = False, out_scale=None):
        """One-kernel INT8 GEMM with the fused epilogue: dequant, bias,
        optional ReLU, optional requantize at ``out_scale``. ``x`` is fp or
        int8 codes (the latter needs a calibrated ``aq``)."""
        lead = x.shape[:-1]
        y = ops.quant_matmul(x.reshape(-1, x.shape[-1]), self.w, self.aq, bias=self.b,
                             relu=relu, out_scale=out_scale)
        return y.reshape(*lead, self.out_features)

    def constrain(self, step=None, schedule: Optional[PruneSchedule] = None) -> None:
        """In place: project the dense weight onto the DBB constraint, or
        with a schedule and a step onto its annealed bound."""
        if not self.fmt.is_dense and isinstance(self.w, torch.Tensor):
            self.put("w", dbb_prune(self.w, scheduled_fmt(self.fmt, step, schedule)))

    def compress_params(self) -> None:
        """In place: the dense weight becomes a compressed :class:`DBBWeight`."""
        if not self.fmt.is_dense and isinstance(self.w, torch.Tensor):
            self.put("w", dbb_encode(self.w, self.fmt, prune=True))

    def flops(self, batch: int) -> int:
        """Executed MACs*2 under the time-unrolled occupancy model."""
        k_eff = (self.in_features // self.fmt.bz) * self.fmt.nnz
        return 2 * batch * k_eff * self.out_features
