"""Seeded weights and images of a ResNet configuration, made on the device,
as ``weights.py`` makes the LM's.

Both sides get what these functions make: the program under test receives
the dense float32 weights (already within the density bound) and the
images; the plain reference draws them again from the same seed. Batch norm
is folded into each conv's weight and bias, as at inference, so a conv is a
weight and a bias. Every conv after the stem, and the head, keeps ``nnz`` of
every ``bz`` rows of its reduction K = kh · kw · C (the same rows for every
output channel: the ``'matrix'`` pattern); the C = 3 stem is dense.
"""
from __future__ import annotations

import math

import torch

from portbench.lib.weights import generator, sparse_normal


def cnn_layout(cfg: dict) -> list:
    """Every conv in the order the program holds them: the stem, then each
    block's 1 × 1, 3 × 3 and 1 × 1 convs and its projection, if any. Each
    entry: name ('stem' or 'b<stage>.<i>.<c1|c2|c3|proj>'), kernel ``k``,
    ``cin``, ``cout``, ``stride``, ``pad`` (on each side), ``dense``."""
    k0 = cfg["stem_kernel"]
    out = [dict(name="stem", k=k0, cin=cfg["in_channels"], cout=cfg["stem_channels"],
                stride=cfg["stem_stride"], pad=cfg["stem_padding"], dense=True)]
    prev = cfg["stem_channels"]
    for si, (inner, n) in enumerate(zip(cfg["stage_channels"], cfg["blocks_per_stage"])):
        wide = inner * cfg["expansion"]
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            pre = f"b{si + 1}.{bi}."
            out += [dict(name=pre + "c1", k=1, cin=prev, cout=inner, stride=1, pad=0, dense=False),
                    dict(name=pre + "c2", k=3, cin=inner, cout=inner, stride=stride, pad=1,
                         dense=False),
                    dict(name=pre + "c3", k=1, cin=inner, cout=wide, stride=1, pad=0, dense=False)]
            if stride != 1 or prev != wide:
                out.append(dict(name=pre + "proj", k=1, cin=prev, cout=wide, stride=stride, pad=0,
                                dense=False))
            prev = wide
    return out


def head_features(cfg: dict) -> int:
    return cfg["stage_channels"][-1] * cfg["expansion"]


def cnn_conv(cfg: dict, seed: int, layer: dict, device) -> dict:
    """One conv's folded weight (k, k, cin, cout) and bias (cout,), float32:
    He's scale over the kept fan-in (sqrt(2 / (k·k·cin · nnz/bz)); the
    stem's whole fan-in), times ``residual_gain`` on a block's last conv."""
    g = generator(seed, "cnn", "conv", layer["name"], device=device)
    d = cfg["dbb"]
    k, cin, cout = layer["k"], layer["cin"], layer["cout"]
    kk = k * k * cin
    keep = 1.0 if layer["dense"] else d["nnz"] / d["bz"]
    std = math.sqrt(2.0 / (kk * keep))
    if layer["name"].endswith(".c3"):
        std *= cfg["residual_gain"]
    bz, nnz = (0, 0) if layer["dense"] else (d["bz"], d["nnz"])
    w = sparse_normal(g, (kk, cout), std, torch.float32, device, bz, nnz)
    b = torch.randn(cout, generator=g, device=device).mul_(cfg["bias_std"])
    return {"w": w.reshape(k, k, cin, cout), "b": b}


def cnn_head(cfg: dict, seed: int, device) -> dict:
    """The FC head (features, classes) within the density bound, and its
    bias."""
    g = generator(seed, "cnn", "head", device=device)
    d = cfg["dbb"]
    f = head_features(cfg)
    w = sparse_normal(g, (f, cfg["num_classes"]), 1.0 / math.sqrt(f * d["nnz"] / d["bz"]),
                      torch.float32, device, d["bz"], d["nnz"])
    b = torch.randn(cfg["num_classes"], generator=g, device=device).mul_(cfg["bias_std"])
    return {"w": w, "b": b}


def cnn_images(cfg: dict, seed: int, tag, batch: int, device) -> torch.Tensor:
    """(batch, H, W, C) float32 images, NHWC, already normalised: standard
    normal values."""
    s, c = cfg["image_size"], cfg["in_channels"]
    return torch.randn((batch, s, s, c), generator=generator(seed, "images", tag, device=device),
                       device=device)
