"""INT8 quantization for the VDBB datapath (port of ``repro/core/quant.py``).

Weights: per-output-channel symmetric, ``scale[n] = max|W[:, n]| / 127``,
int8 values kept in the compressed (nb, nnz, N) layout. Activations:
per-tensor symmetric, from calibration ``ActStats.absmax`` or from the live
batch. Accumulation: exact int32; the float result is recovered on the
accumulator flush.

``torch.round`` rounds half to even, as ``jnp.round`` does. Every division
here divides by a tensor on the operand's device: for a Python scalar
divisor PyTorch's CUDA kernel multiplies by the reciprocal, which is not an
IEEE division and can move an int8 code by one.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.vdbb import DBBFormat, DBBWeight, dbb_decode, gather_compressed

QMAX = 127  # symmetric int8: [-127, 127]; -128 unused so negation is safe


def as_f32(v, device) -> torch.Tensor:
    """``v`` (a number or a tensor) as an fp32 tensor on ``device``. A number
    is filled in on the device, with no copy from the host, so that a CUDA
    graph can capture it."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), v, dtype=torch.float32, device=device)


def weight_scales(values: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scales from compressed (nb, nnz, N), or
    (L, N) from stacked (L, nb, nnz, N)."""
    amax = values.float().abs().amax(dim=(-3, -2))
    return amax.clamp_min(1e-12) / as_f32(QMAX, amax.device)


def dynamic_act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric scale from the live batch (dynamic quant)."""
    amax = x.float().abs().amax().clamp_min(1e-12)
    return amax / as_f32(QMAX, amax.device)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric round-to-nearest-even int8: clip(round(x / scale), ±QMAX).
    NaN is code 0 on every device, as the reference's int8 cast gives it
    (the card's cast of a NaN is not relied on)."""
    q = torch.round(x.float() / as_f32(scale, x.device))
    return q.clamp(-QMAX, QMAX).nan_to_num(nan=0.0).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * as_f32(scale, q.device)


def resolve_quant_input(x: torch.Tensor, act_scale):
    """(int8 codes, scale): fp input is quantized per-tensor (calibrated
    ``act_scale`` or dynamic); an int8 input is already the previous layer's
    codes and must come with the scale it was quantized at."""
    if x.dtype == torch.int8:
        if act_scale is None:
            raise ValueError(
                "int8-resident input needs its activation scale: pass the "
                "calibrated act_scale the codes were quantized with"
            )
        return x, as_f32(act_scale, x.device)
    s_a = dynamic_act_scale(x) if act_scale is None else as_f32(act_scale, x.device)
    return quantize(x, s_a), s_a


def act_scale_from_stats(stats) -> float:
    """Static per-tensor scale from calibration ``ActStats`` (``absmax``)."""
    amax = float(getattr(stats, "absmax"))
    if not amax > 0.0:
        raise ValueError(f"calibration stats carry no absmax: {stats!r}")
    return amax / QMAX


@dataclasses.dataclass
class QuantDBBWeight:
    """INT8-quantized compressed DBB weight: int8 (nb, nnz, N) values, the
    unchanged int8 positions, (N,) fp32 per-channel scales. Stacked (a
    leading layers axis, as :class:`DBBWeight`): values (L, nb, nnz, N),
    scales (L, N); ``qw[g]`` is group ``g``'s weight."""

    values: torch.Tensor
    indices: torch.Tensor
    scales: torch.Tensor
    fmt: DBBFormat
    shape: tuple

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def __getitem__(self, g) -> "QuantDBBWeight":
        if self.values.dim() != 4:
            raise TypeError("only a stacked QuantDBBWeight (a leading layers axis) is indexed")
        return dataclasses.replace(self, values=self.values[g], indices=self.indices[g],
                                   scales=self.scales[g])

    def as_dbb(self) -> DBBWeight:
        """The int8 compressed weight viewed as a plain DBBWeight."""
        return DBBWeight(self.values, self.indices, self.fmt, self.shape)

    def nbytes_compressed(self) -> int:
        """Stored bytes: int8 values + bitmask + fp32 scales."""
        return self.as_dbb().nbytes_compressed() + self.scales.numel() * 4

    def to(self, device) -> "QuantDBBWeight":
        return dataclasses.replace(self, values=self.values.to(device),
                                   indices=self.indices.to(device),
                                   scales=self.scales.to(device))


def quantize_dbb(dw: DBBWeight) -> QuantDBBWeight:
    """Symmetric per-output-channel quantization of a compressed weight,
    stacked or not."""
    if not dw.values.dtype.is_floating_point:
        raise ValueError(f"weight already integer: {dw.values.dtype}")
    scales = weight_scales(dw.values)
    qvals = quantize(dw.values, scales[..., None, None, :])
    return QuantDBBWeight(qvals, dw.indices, scales, dw.fmt, dw.shape)


def dequantize_dbb(qw: QuantDBBWeight) -> DBBWeight:
    """fp32 DBBWeight carrying the (lossy) round-tripped values."""
    return DBBWeight(dequantize(qw.values, qw.scales[..., None, None, :]),
                     qw.indices, qw.fmt, qw.shape)


def int_matmul_ref(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer operands. On the CPU in int64; on
    the card in float64, which is exact while |acc| < 2**53 (int8 operands
    over K < 5.5e8) — PyTorch has no integer matmul there."""
    if aq.device.type == "cpu":
        return (aq.long() @ wq.long()).to(torch.int32)
    return (aq.double() @ wq.double()).round().to(torch.int32)


def quant_matmul_ref(aq: torch.Tensor, qw: QuantDBBWeight, act_scale) -> torch.Tensor:
    """int8 A × quantized compressed W -> fp32, via the decoded int8 weight."""
    acc = int_matmul_ref(aq, dbb_decode(qw.as_dbb()))
    return acc.float() * (as_f32(act_scale, aq.device) * qw.scales)[None, :]


def quant_matmul_gather_ref(aq: torch.Tensor, qw: QuantDBBWeight, act_scale) -> torch.Tensor:
    """Compressed-K int8 matmul (group='matrix' only), bit-identical to
    :func:`quant_matmul_ref` without materializing the dense weight."""
    k, n = qw.shape
    if qw.fmt.group_size(n) != n:
        raise ValueError("gather formulation requires group='matrix'")
    ac = gather_compressed(aq, qw.indices[:, :, 0], qw.fmt.bz)
    acc = int_matmul_ref(ac, qw.values.reshape(-1, n))
    return acc.float() * (as_f32(act_scale, aq.device) * qw.scales)[None, :]


def quant_conv_ref(xq: torch.Tensor, qw: QuantDBBWeight, kh: int, kw: int,
                   act_scale, *, stride=1, padding="SAME") -> torch.Tensor:
    """int8 NHWC conv oracle: exact int32 accumulator + dequant."""
    from repro_torch.kernels.ref import sparse_conv_int_ref

    acc = sparse_conv_int_ref(xq, qw.as_dbb(), kh, kw, stride=stride, padding=padding)
    return acc.float() * (as_f32(act_scale, xq.device) * qw.scales)
