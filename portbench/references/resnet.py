"""The plain reference of ResNet v1.5 (torchvision's ``resnet50`` layout):
a 7 × 7 stride-2 stem conv with ReLU, a 3 × 3 stride-2 max-pool, bottleneck
blocks (1 × 1, 3 × 3 carrying the block's stride, 1 × 1; the shortcut,
projected by a strided 1 × 1 conv where the shape changes, added before the
last ReLU), global average pooling and a linear head. Batch norm is folded
into each conv's weight and bias (``portbench.lib.cnn_weights``). Plain
PyTorch in float32 with TF32 off: ``F.conv2d`` with the published pads,
``F.max_pool2d``, the residual adds, a mean and the head. It imports nothing
of the program, and the tests hold the program against this same file.

``mode`` sets how every conv but the stem, and the head, computes:

- ``"fp32"``: the dense float32 layer;
- ``"int8"`` / ``"int4"``: the served INT8 chain worked out again: the
  compression (the weights' kept rows, already within the bound),
  per-output-channel symmetric weight codes, a static per-tensor activation
  scale per tensor from :func:`calibrate` (``absmax / qmax``; a block's
  first conv and its projection read one tensor, so one scale; a
  projection's output its own), round half to even, exact integer sums (in
  float64: K · 127² passes 2²⁴, not 2⁵³), the dequantize, bias, residual
  (its codes times their scale), ReLU and requantize each rounded once in
  float32. The stem stays float32 and requantizes its output; the max-pool
  pools codes. ``"int4"`` (qmax 7) is the control for INT8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.lib.cnn_weights import cnn_conv, cnn_head, cnn_layout

QMAX = {"int8": 127, "int4": 7}


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


class _Net:
    """One forward's layers, drawn again from the seed, and how they compute."""

    def __init__(self, cfg: dict, seed: int, device, mode: str, amax=None, record=None):
        self.cfg, self.seed, self.dev = cfg, seed, device
        self.mode, self.amax, self.record = mode, amax, record
        self.q = QMAX.get(mode)

    def note(self, name: str, x) -> None:
        if self.record is not None:
            self.record[name] = max(self.record.get(name, 0.0), x.abs().amax().item())

    def scale(self, name: str):
        """The static activation scale of a tensor: absmax / qmax, in float32."""
        return _f32(self.amax[name] / self.q, self.dev)

    def quantize(self, x, s):
        return torch.round(x / s).clamp(-self.q, self.q)

    def conv_acc(self, layer, x, w):
        """(N, C, H, W) codes -> the layer's exact integer sum (float64),
        rounded once to float32."""
        wt = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(stride=layer["stride"], padding=layer["pad"])
        return F.conv2d(x.double(), wt.double(), **kw).float()

    def weight_codes(self, w, axes):
        """Per-output-channel codes and scales of a (…, F) weight."""
        ws = w.abs().amax(dim=axes).clamp_min(1e-12) / _f32(self.q, w.device)
        return self.quantize(w, ws), ws

    def conv(self, layer, x, sa=None, res=None, relu=True, out=None):
        """One conv. Float32 (the fp32 mode, and the stem: no ``sa``): x ->
        relu?(conv + b + res). Quantized: x codes at ``sa`` -> dequantize
        (acc · (sa · ws)), + b, + res (codes, scale), ReLU, requantize at
        ``out`` (None: float32 out)."""
        p = cnn_conv(self.cfg, self.seed, layer, self.dev)
        w, b = p["w"].float(), p["b"].float()
        if sa is None:
            y = F.conv2d(x, w.permute(3, 2, 0, 1).contiguous(), stride=layer["stride"],
                         padding=layer["pad"]) + b[None, :, None, None]
            if res is not None:
                y = y + res
            return torch.relu(y) if relu else y
        wq, ws = self.weight_codes(w, (0, 1, 2))
        y = self.conv_acc(layer, x, wq) * (sa * ws)[None, :, None, None]
        y = y + b[None, :, None, None]
        if res is not None:
            y = y + res[0] * res[1]
        if relu:
            y = torch.relu(y)
        return y if out is None else self.quantize(y, out)


def forward(cfg: dict, seed: int, images: torch.Tensor, mode: str = "fp32", amax=None,
            record=None) -> torch.Tensor:
    """Float32 logits (B, classes) of ``images`` (B, H, W, C), NHWC. ``amax``
    ({tensor name: absmax}, from :func:`calibrate`) for the integer modes;
    ``record`` (a dict) collects every such absmax of a float32 pass."""
    _no_tf32()
    dev = images.device
    net = _Net(cfg, seed, dev, mode, amax, record)
    layout = cnn_layout(cfg)
    stem, convs = layout[0], {c["name"]: c for c in layout[1:]}
    blocks = sorted({n.rsplit(".", 1)[0] for n in convs},
                    key=lambda b: tuple(int(v) for v in b[1:].split(".")))
    x = images.permute(0, 3, 1, 2).float()
    k, s, pad = cfg["max_pool"]
    first = blocks[0] + ".c1"
    y = net.conv(stem, x)  # the stem: float32 in every mode
    if net.q is not None:
        y = net.quantize(y, net.scale(first))  # pooling codes = codes of the pool
    x = F.max_pool2d(y, k, s, pad)
    for j, blk in enumerate(blocks):
        c1, c2, c3, proj = (convs.get(f"{blk}.{n}") for n in ("c1", "c2", "c3", "proj"))
        net.note(c1["name"], x)
        if net.q is None:
            t = net.conv(c1, x)
            net.note(c2["name"], t)
            t = net.conv(c2, t)
            net.note(c3["name"], t)
            r = x
            if proj is not None:
                r = net.conv(proj, x, relu=False)
                net.note(proj["name"] + ".out", r)
            x = net.conv(c3, t, res=r)
            continue
        sa = net.scale(c1["name"])
        t = net.conv(c1, x, sa, out=net.scale(c2["name"]))
        t = net.conv(c2, t, net.scale(c2["name"]), out=net.scale(c3["name"]))
        r = (x, sa)
        if proj is not None:
            so = net.scale(proj["name"] + ".out")
            r = (net.conv(proj, x, sa, relu=False, out=so), so)
        nxt = net.scale(blocks[j + 1] + ".c1") if j + 1 < len(blocks) else None
        x = net.conv(c3, t, net.scale(c3["name"]), res=r, out=nxt)
    x = x.mean(dim=(2, 3))  # global average pool over the float32 flush
    net.note("head", x)
    h = cnn_head(cfg, seed, dev)
    w, b = h["w"].float(), h["b"].float()
    if net.q is None:
        return x @ w + b
    sa = net.scale("head")
    wq, ws = net.weight_codes(w, (0,))
    acc = (net.quantize(x, sa).double() @ wq.double()).float()
    return acc * (sa * ws) + b


def calibrate(cfg: dict, seed: int, images: torch.Tensor) -> dict:
    """The absmax of every tensor the integer modes requantize or read at a
    static scale, over a float32 pass of ``images``: {"<block>.c1" | ".c2" |
    ".c3" | ".proj.out" | "head": absmax}."""
    record = {}
    forward(cfg, seed, images, "fp32", record=record)
    return record
