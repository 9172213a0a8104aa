"""DBBConv2d — the VDBB layer on its native workload (port of
``repro/core/sparse_conv.py``). NHWC input, HWIO weight, DBB along
K = kh·kw·C; same state and in-place lifecycle as :class:`DBBLinear`.

Every conv runs a fused kernel: a compressed weight the IM2COL × VDBB
kernel, a dense one (the C = 3 stem) the dense IM2COL kernel, each in its
fp32 or int8 instantiation.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QuantDBBWeight, quantize
from repro_torch.core.sparse_linear import DBBLayer, PruneSchedule, scheduled_fmt, trunc_normal
from repro_torch.core.vdbb import DBBFormat, DBBWeight, DENSE, dbb_encode_conv, dbb_prune
from repro_torch.kernels import ops
from repro_torch.kernels.core import _pair, conv_geometry


class DBBConv2d(DBBLayer):
    """y = conv2d(x, W) (+ b); x NHWC, W (kh, kw, C, F)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 padding="SAME", fmt: DBBFormat = DENSE, use_bias: bool = False):
        super().__init__(fmt, use_bias)
        if not fmt.is_dense and in_channels % fmt.bz != 0:
            raise ValueError(
                f"in_channels={in_channels} not divisible by bz={fmt.bz}: "
                "DBB blocks must not straddle kernel taps"
            )
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kh, self.kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), padding

    def _project(self, w4: torch.Tensor, fmt: DBBFormat) -> torch.Tensor:
        kh, kw, c, f = w4.shape
        return dbb_prune(w4.reshape(kh * kw * c, f), fmt).reshape(w4.shape)

    def init(self, generator: torch.Generator, device) -> None:
        fan_in = self.kh * self.kw * self.in_channels
        w = trunc_normal((self.kh, self.kw, self.in_channels, self.out_channels),
                         generator, 1.0 / fan_in**0.5).to(device)
        if not self.fmt.is_dense:
            w = self._project(w, self.fmt)
        self.put("w", w)
        self._init_bias(self.out_channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.w, self.b, self.aq)

    def _conv(self, x, w, b, aq, choice=None):
        conv = dict(stride=self.stride, padding=self.padding, choice=choice)
        if isinstance(w, QuantDBBWeight):
            y = ops.quant_conv(x, w, self.kh, self.kw, aq, **conv)
        elif isinstance(w, DBBWeight):
            y = ops.sparse_conv(x, w, self.kh, self.kw, **conv)
        else:
            y = ops.fused_im2col_conv(x, w.to(x.dtype), **conv)
        if self.use_bias:
            y = y + b.to(y.dtype)
        return y

    def make_plan(self, *, batch: int, h: int, w: int, relu: bool = False, out_scale=None,
                  fused: bool = False, tune: str = "cache", cache=None, top_k: int = 4,
                  reps: int = 3, choice=None, res_scale=None):
        """Stage this layer's serving step once for a (batch, h, w) input
        (port of the reference's ``make_plan``). The launch choice is
        ``choice`` when given (a data-parallel replica takes its bucket's),
        else resolved here under ``tune`` (``autotune.tiles_for_conv``: the
        registry, then ``cache``, then a search for ``'search'``; the rule's
        otherwise, and always on the CPU) and frozen into the stage. Returns
        ``(run, tiles)``: ``run`` is ``x -> y`` with the layer's current
        state frozen in, on the path :meth:`SparseCNN.forward` takes. With
        ``fused`` (the int8-resident chain) it is :meth:`quant_serve` or, for
        the dense stem, :meth:`dense_serve`, staged through ``ops.stage_*``,
        and ``tiles`` is the int8 tile plan or the stem's path; otherwise it
        is the per-layer conv (+ bias), then ReLU and a requantize at
        ``out_scale`` when asked, and ``tiles`` a tuned choice, if any.
        ``res_scale`` (a ResNet block's last conv on the fused chain) stages
        the flush with the shortcut's codes at that scale: ``run(x,
        residual)``."""
        from repro_torch.kernels import autotune

        wt, b, aq = self.w, self.b, self.aq
        x_shape = (batch, h, w, self.in_channels)
        geom = dict(stride=self.stride, padding=self.padding)
        quant = isinstance(wt, QuantDBBWeight)
        fmt = wt.fmt if isinstance(wt, (DBBWeight, QuantDBBWeight)) else None
        dtype = torch.int8 if quant else (wt.dtype if fmt is None else wt.values.dtype)
        autotune.check_mode(tune)
        if choice is None:
            choice = autotune.tiles_for_conv(
                batch, h, w, self.in_channels, self.out_channels, self.kh, self.kw, fmt, dtype,
                **geom, mode=tune, cache=cache, top_k=top_k, reps=reps,
                device=(wt if fmt is None else wt.values).device)
        if res_scale is not None and not (fused and quant):
            raise ValueError("a residual flush is staged on the fused int8 chain only")
        if fused and quant:
            return ops.stage_quant_conv(wt, self.kh, self.kw, aq, x_shape, bias=b, relu=relu,
                                        out_scale=out_scale, **geom, choice=choice,
                                        res_scale=res_scale)
        if fused:
            return ops.stage_fused_im2col_conv(wt, x_shape, bias=b, relu=relu,
                                               out_scale=out_scale, **geom, choice=choice)

        def run(x):
            y = self._conv(x, wt, b, aq, choice)
            if relu:
                y = torch.relu(y)
            return y if out_scale is None else quantize(y, out_scale)

        return run, dict(choice)

    def quant_serve(self, x: torch.Tensor, *, relu: bool = False, out_scale=None,
                    residual=None):
        """One-kernel INT8 conv with the fused epilogue; int8 codes out when
        ``out_scale`` is given, fp32 otherwise. ``x`` is fp or int8 codes
        (the latter needs a calibrated ``aq``). ``residual`` = (int8 codes
        of the output's shape, their scale) is added in the flush before
        ReLU (a ResNet block's shortcut)."""
        return ops.quant_conv(x, self.w, self.kh, self.kw, self.aq, bias=self.b,
                              relu=relu, out_scale=out_scale, stride=self.stride,
                              padding=self.padding, residual=residual)

    def dense_serve(self, x: torch.Tensor, *, relu: bool = False, out_scale=None):
        """The dense (fp32) conv as one kernel with bias, ReLU and the
        requantize fused: the stem of the int8-resident chain."""
        return ops.fused_im2col_conv(x, self.w, bias=self.b, relu=relu,
                                     out_scale=out_scale, stride=self.stride,
                                     padding=self.padding)

    def constrain(self, step=None, schedule: Optional[PruneSchedule] = None) -> None:
        """In place: project the dense weight onto the DBB constraint, or
        with a schedule and a step onto its annealed bound."""
        if not self.fmt.is_dense and isinstance(self.w, torch.Tensor):
            self.put("w", self._project(self.w, scheduled_fmt(self.fmt, step, schedule)))

    def compress_params(self) -> None:
        if not self.fmt.is_dense and isinstance(self.w, torch.Tensor):
            self.put("w", dbb_encode_conv(self.w, self.fmt, prune=True))

    def out_hw(self, h: int, w: int) -> tuple:
        _, _, (ho, wo) = conv_geometry(h, w, self.kh, self.kw, self.stride, self.padding)
        return ho, wo

    def flops(self, batch: int, h: int, w: int) -> int:
        """Executed MACs*2 under the time-unrolled occupancy model."""
        ho, wo = self.out_hw(h, w)
        k = self.kh * self.kw * self.in_channels
        return 2 * batch * ho * wo * (k // self.fmt.bz) * self.fmt.nnz * self.out_channels
