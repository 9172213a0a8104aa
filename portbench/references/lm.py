"""The plain reference of the decoder LM (StarCoder2's block): pre-LayerNorm
(eps 1e-5, gain and shift), grouped-query attention with q/k/v biases and
rotary embeddings (the half-split rotation, ``theta ** (i / half)``),
causal softmax attention, a tanh-approximated GELU MLP without biases, a
final LayerNorm and a dense head. Plain PyTorch in float32 with TF32 off,
run layer by layer with each layer's weights drawn again from the seed
(``portbench.lib.weights``), so the whole model never sits on the card in
float32. It imports nothing of the program.

``mode`` sets how every projection (not the head) computes:

- ``"fp32"``: the dense float32 product;
- ``"int8"`` / ``"int4"``: the served INT8 path worked out again:
  per-output-channel symmetric weight codes, a static per-tensor activation
  scale per projection and layer from :func:`calibrate` (``absmax /
  qmax``), round half to even, exact sums, dequantized; ``"int4"`` (qmax 7)
  is the control for INT8;
- ``"fp8"``: e4m3 with a per-output-channel weight scale and a per-call
  activation scale (``amax / 448``), the control for bfloat16.
"""
from __future__ import annotations

import math

import torch

from portbench.lib import weights

QMAX = {"int8": 127, "int4": 7}
FP8_MAX = 448.0


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _div(x, q):
    return x / torch.tensor(float(q), dtype=torch.float32, device=x.device)


def layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def rope(x, positions, theta: float):
    """x (B, S, H, D), positions (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Projector:
    """``x @ W`` of one projection in the mode's precision. ``record``
    (a dict) collects each projection input's absmax under its name."""

    def __init__(self, mode: str, amax=None, record=None):
        self.mode, self.amax, self.record = mode, amax, record

    def __call__(self, name: str, x, w):
        w = w.float()
        if self.record is not None:
            self.record[name] = max(self.record.get(name, 0.0), x.abs().amax().item())
        if self.mode == "fp32":
            return x @ w
        if self.mode in QMAX:
            q = QMAX[self.mode]
            ws = _div(w.abs().amax(dim=0).clamp_min(1e-12), q)
            sa = torch.tensor(self.amax[name] / q, dtype=torch.float32, device=x.device)
            wq = torch.round(w / ws).clamp(-q, q)
            xq = torch.round(x / sa).clamp(-q, q)
            # integer sums below 2**24 are exact in float32; larger ones round
            # at 2**-24 relative, far below the comparison's scale
            return (xq @ wq) * (sa * ws)
        if self.mode == "fp8":
            f8 = torch.float8_e4m3fn
            ws = _div(w.abs().amax(dim=0).clamp_min(1e-12), FP8_MAX)
            sa = _div(x.abs().amax().clamp_min(1e-12), FP8_MAX)
            return ((x / sa).to(f8).float() @ (w / ws).to(f8).float()) * (sa * ws)
        raise ValueError(f"unknown mode {self.mode!r}")


def forward(cfg: dict, seed: int, tokens: torch.Tensor, mode: str = "fp32", amax=None,
            record=None, last_only: bool = False) -> torch.Tensor:
    """Float32 logits (B, S, V) of ``tokens`` (B, S) at positions 0 … S-1
    (``last_only``: (B, V) of the last position). ``amax`` ({name:
    absmax}, from :func:`calibrate`) for the integer modes; ``record`` (a
    dict) collects the projection inputs' absmax."""
    _no_tf32()
    dev = tokens.device
    outer = weights.lm_outer(cfg, seed, dev)
    b, s = tokens.shape
    h_, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    x = outer["embed"].float()[tokens.long()]
    pos = torch.arange(s, device=dev)
    mask = pos[:, None] >= pos[None, :]
    scale = 1.0 / math.sqrt(hd)
    for layer in range(cfg["num_layers"]):
        w = weights.lm_layer(cfg, seed, layer, dev)
        proj = Projector(mode, amax, record)
        name = f"{layer}."
        h = layer_norm(x, w["norm1_g"], w["norm1_b"])
        q = (proj(name + "qkv", h, w["wq"]) + w["bq"].float()).reshape(b, s, h_, hd)
        k = (proj(name + "qkv", h, w["wk"]) + w["bk"].float()).reshape(b, s, kv, hd)
        v = (proj(name + "qkv", h, w["wv"]) + w["bv"].float()).reshape(b, s, kv, hd)
        q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
        k = k.repeat_interleave(h_ // kv, dim=2)
        v = v.repeat_interleave(h_ // kv, dim=2)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, h_ * hd)
        del att, q, k, v
        x = x + proj(name + "wo", o, w["wo"])
        h = layer_norm(x, w["norm2_g"], w["norm2_b"])
        up = gelu(proj(name + "w_up", h, w["w_up"]))
        x = x + proj(name + "w_down", up, w["w_down"])
        del w, h, up, o
    if last_only:
        x = x[:, -1]
    x = layer_norm(x, outer["final_g"], outer["final_b"])
    return x @ outer["lm_head"].float()


def calibrate(cfg: dict, seed: int, tokens: torch.Tensor) -> dict:
    """The absmax of every projection's input over a float32 pass of
    ``tokens``: {"<layer>.qkv" | ".wo" | ".w_up" | ".w_down": absmax}."""
    record = {}
    forward(cfg, seed, tokens, "fp32", record=record, last_only=True)
    return record
