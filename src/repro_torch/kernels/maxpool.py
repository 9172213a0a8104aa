"""Max-pool over NHWC (ResNet's pool after the stem): the CUDA kernel
``csrc/maxpool.cuh`` (entry ``maxpool_nhwc`` of ``im2col_conv.cu``, counted
as ``im2col_conv_maxpool``) and its plain PyTorch version. int8 codes pool to int8
codes at the same scale (max commutes with the monotone requantize), fp32 to
fp32 (the calibration forward). Padding takes no part: a window's taps
outside the image are skipped, as a pad of -inf would be."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.im2col_conv import KERNEL

RUN = 16  # csrc/maxpool.cuh: channels a thread, one 16-byte int8 vector


def out_hw(h: int, w: int, k: int, s: int, pad: int) -> tuple:
    """PyTorch's output size (floor mode) of a k x k pool at stride s, pad."""
    return (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1


def maxpool_plain(x: torch.Tensor, k: int, s: int, pad: int) -> torch.Tensor:
    """Plain version: ``F.max_pool2d`` on the NCHW view; int8 codes pool in
    fp32, where every code is exact."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2).float(), k, s, pad)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def maxpool(x: torch.Tensor, k: int, s: int, pad: int) -> torch.Tensor:
    """k x k max-pool at stride ``s`` with ``pad`` on each side of an NHWC
    int8 or fp32 tensor. CPU tensors take the plain version; CUDA tensors
    launch the kernel, which takes C a multiple of 16 and a pad below k."""
    if x.device.type == "cpu":
        return maxpool_plain(x, k, s, pad)
    n, h, w, c = x.shape
    if c % RUN or pad >= k:
        raise ValueError(f"maxpool: C={c} must be a multiple of {RUN} and pad {pad} below "
                         f"the kernel {k}")
    in_kind = build.check_operands("im2col_conv_maxpool", x, dtype=x.dtype)
    ho, wo = out_hw(h, w, k, s, pad)
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), out.data_ptr(), in_kind, n, h, w, c, ho, wo, k, s, pad,
                  build.stream_of(x), variant="maxpool")
    return out
