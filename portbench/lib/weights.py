"""Seeded inputs and weights, made on the device.

Both sides get what these functions make: the program under test receives
the dense weights (already within the density bound) and the inputs; the
plain reference draws them again from the same seed after the program is
gone. Every tensor has a generator of its own, keyed by the run's seed and a
tag, so a part can be drawn again alone and a seed of any size is taken.

The weights satisfy the VDBB bound by construction: in every block of
``bz`` rows along the reduction axis, ``nnz`` rows are drawn and the others
are zero, the same rows for every output column (the ``'matrix'`` pattern).
So magnitude pruning keeps exactly the drawn rows on any device and in any
precision, and compression loses nothing.
"""
from __future__ import annotations

import hashlib
import math

import torch


def generator(seed: int, *tags, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``tags``."""
    key = "|".join([str(int(seed))] + [str(t) for t in tags]).encode()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1)
    return g


def block_rows(g: torch.Generator, lead: tuple, k: int, bz: int, nnz: int, device) -> torch.Tensor:
    """A (*lead, k, 1) 0/1 float mask keeping ``nnz`` random rows of every
    block of ``bz`` rows."""
    scores = torch.rand(lead + (k // bz, bz), generator=g, device=device)
    keep = scores.argsort(dim=-1)[..., :nnz]
    mask = torch.zeros_like(scores).scatter_(-1, keep, 1.0)
    return mask.reshape(lead + (k, 1))


def sparse_normal(g, shape: tuple, std: float, dtype, device, bz: int = 0, nnz: int = 0):
    """Normal entries of ``std`` in ``dtype``, with ``nnz`` of every ``bz``
    rows along the second-last axis kept (``bz`` 0: dense)."""
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32).mul_(std)
    if bz:
        w.mul_(block_rows(g, tuple(shape[:-2]), shape[-2], bz, nnz, device))
    return w.to(dtype)


def lm_layout(cfg: dict) -> dict:
    """The projections of one layer: name -> (K, N)."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    h, kv, ff = cfg["num_heads"], cfg["num_kv_heads"], cfg["d_ff"]
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
            "w_up": (d, ff), "w_down": (ff, d)}


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def lm_layer(cfg: dict, seed: int, layer: int, device) -> dict:
    """One layer's dense weights in bf16: its projections (K, N) within the
    density bound, the q/k/v biases and both LayerNorms' gain and shift."""
    g = generator(seed, "lm", "layer", layer, device=device)
    bz, nnz = cfg["dbb"]["bz"], cfg["dbb"]["nnz"]
    bf = torch.bfloat16
    out = {name: sparse_normal(g, kn, 1.0 / math.sqrt(kn[0] * nnz / bz), bf, device, bz, nnz)
           for name, kn in lm_layout(cfg).items()}
    d = cfg["d_model"]
    for name in ("bq", "bk", "bv"):
        n = out["w" + name[1]].shape[1]
        out[name] = torch.randn(n, generator=g, device=device).mul_(0.1).to(bf)
    for norm in ("norm1", "norm2"):
        out[norm + "_g"] = (1.0 + 0.1 * torch.randn(d, generator=g, device=device)).to(bf)
        out[norm + "_b"] = (0.1 * torch.randn(d, generator=g, device=device)).to(bf)
    return out


def lm_outer(cfg: dict, seed: int, device) -> dict:
    """The embedding table (V, d), the final LayerNorm and the dense head
    (d, V), bf16, V the vocabulary padded to a multiple of 256."""
    g = generator(seed, "lm", "outer", device=device)
    d, v = cfg["d_model"], padded_vocab(cfg)
    bf = torch.bfloat16
    return {"embed": torch.randn((v, d), generator=g, device=device).to(bf),
            "final_g": (1.0 + 0.1 * torch.randn(d, generator=g, device=device)).to(bf),
            "final_b": (0.1 * torch.randn(d, generator=g, device=device)).to(bf),
            "lm_head": torch.randn((d, v), generator=g, device=device).mul_(
                1.0 / math.sqrt(d)).to(bf)}


def lm_tokens(cfg: dict, seed: int, tag, batch: int, seq: int, device) -> torch.Tensor:
    """(batch, seq) int32 token ids, uniform over the vocabulary."""
    return torch.randint(0, cfg["vocab_size"], (batch, seq),
                         generator=generator(seed, "tokens", tag, device=device),
                         device=device).to(torch.int32)
