"""GQA attention (port of ``repro/models/attention.py``: ``GQAttention``,
``_attend`` and ``attend_chunked``).

Attention is plain jnp in the reference, not a Pallas kernel, so it is plain
torch here, in the reference's dtypes: the score product in the activation
dtype, then fp32 scores, the ``NEG_INF`` mask and an fp32 softmax, the
probabilities cast back for the value product. The full-sequence path
repeats K/V to the query heads before attention (q-chunked when S exceeds
``q_chunk``); decode reads the compact KV cache, a ring buffer for a local
``window``. ``MLAttention`` and cross-attention are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import Param, apply_linear, linear_def, rope

NEG_INF = -1e30
_NO_POS = 2**31 - 1  # an unfilled ring slot: later than every query


def _attend(q, k, v, q_pos, k_pos, *, window: int = 0, kv_valid_len=None):
    """q: (B,Sq,Kv,G,D); k/v: (B,Sk,Kv,D); positions for causal masking.
    Returns (B,Sq,Kv,G,D)."""
    d = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))  # fp32, as the reference's
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    mask = q_pos[:, None] >= k_pos[None, :]  # causal
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    if kv_valid_len is not None:
        mask &= k_pos[None, :] < kv_valid_len
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def attend_chunked(q, k, v, q_pos, k_pos, *, window=0, q_chunk=1024, kv_valid_len=None):
    b, sq, kvh, g, d = q.shape
    if sq <= q_chunk:
        return _attend(q, k, v, q_pos, k_pos, window=window, kv_valid_len=kv_valid_len)
    assert sq % q_chunk == 0, (sq, q_chunk)
    return torch.cat([
        _attend(q[:, i: i + q_chunk], k, v, q_pos[i: i + q_chunk], k_pos, window=window,
                kv_valid_len=kv_valid_len)
        for i in range(0, sq, q_chunk)], dim=1)


@dataclasses.dataclass(frozen=True)
class GQAttention:
    cfg: "ModelConfig"  # noqa: F821
    window: int = 0  # 0 = global causal
    cross: bool = False

    def __post_init__(self):
        if self.cross:
            raise NotImplementedError("cross-attention is not ported (ROADMAP queue 1, item 12)")

    def defs(self):
        c = self.cfg
        hd = c.hd
        dbb = c.dbb
        d = {
            "wq": linear_def(c.d_model, c.num_heads * hd, "embed", "heads", dbb=dbb),
            "wk": linear_def(c.d_model, c.num_kv_heads * hd, "embed", "kv", dbb=dbb),
            "wv": linear_def(c.d_model, c.num_kv_heads * hd, "embed", "kv", dbb=dbb),
            "wo": linear_def(c.num_heads * hd, c.d_model, "heads", "embed", dbb=dbb),
        }
        if c.qkv_bias:
            d["bq"] = Param((c.num_heads * hd,), ("heads",), "zeros")
            d["bk"] = Param((c.num_kv_heads * hd,), ("kv",), "zeros")
            d["bv"] = Param((c.num_kv_heads * hd,), ("kv",), "zeros")
        return d

    def _proj(self, p, x, name, bias=None):
        return apply_linear(x, p[name], p.get(bias) if bias else None, aq=p.get(f"{name}_aq"),
                            name=name)

    # -------------------------------------------------------------- full
    def __call__(self, p, x, positions):
        """Full-sequence forward. x: (B,S,d). Returns (out, cache_kv)."""
        c = self.cfg
        hd = c.hd
        b, s, _ = x.shape
        q = self._proj(p, x, "wq", "bq").reshape(b, s, c.num_heads, hd)
        k = self._proj(p, x, "wk", "bk").reshape(b, s, c.num_kv_heads, hd)
        v = self._proj(p, x, "wv", "bv").reshape(b, s, c.num_kv_heads, hd)
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
        k_cache, v_cache = k, v  # the cache keeps the compact kv-head layout
        g = c.num_heads // c.num_kv_heads
        if g > 1:  # expand KV to the query heads before attention, as the reference
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        qg = q.reshape(b, s, c.num_heads, 1, hd)
        pos1 = positions[0] if positions.dim() == 2 else positions
        out = attend_chunked(qg, k, v, pos1, pos1, window=self.window, q_chunk=c.q_chunk)
        y = self._proj(p, out.reshape(b, s, c.num_heads * hd), "wo")
        return y, {"k": k_cache, "v": v_cache}

    # ------------------------------------------------------------ decode
    def init_cache(self, batch, max_len, dtype, device=None):
        c = self.cfg
        cap = min(self.window, max_len) if self.window else max_len
        shape = (batch, cap, c.num_kv_heads, c.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, p, x, cache, pos):
        """x: (B,1,d); ``pos`` the current position, a 0-d int64 tensor on
        x's device. The slot, the ring's positions and the valid length are
        device ops on it, so a CUDA graph of the step replays at any
        position. Writes the new K/V into ``cache`` in place (the reference
        returns an updated copy) and returns (y, cache)."""
        c = self.cfg
        hd = c.hd
        b = x.shape[0]
        posv = pos.reshape(1, 1).expand(b, 1)
        q = rope(self._proj(p, x, "wq", "bq").reshape(b, 1, c.num_heads, hd), posv, c.rope_theta)
        k_new = rope(self._proj(p, x, "wk", "bk").reshape(b, 1, c.num_kv_heads, hd), posv,
                     c.rope_theta)
        v_new = self._proj(p, x, "wv", "bv").reshape(b, 1, c.num_kv_heads, hd)
        cap = cache["k"].shape[1]
        slot = pos % cap if self.window else pos.clamp(max=cap - 1)
        cache["k"].index_copy_(1, slot.reshape(1), k_new.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot.reshape(1), v_new.to(cache["v"].dtype))
        qg = q.reshape(b, 1, c.num_kv_heads, c.num_heads // c.num_kv_heads, hd)
        kpos = torch.arange(cap, dtype=torch.int64, device=x.device)
        if self.window:  # ring buffer: the absolute position of each slot
            base = pos - slot
            kpos = torch.where(kpos <= slot, base + kpos, base - cap + kpos)
            kpos = torch.where(kpos < 0, torch.full_like(kpos, _NO_POS), kpos)
        out = _attend(qg, cache["k"], cache["v"], pos.reshape(1), kpos, window=self.window,
                      kv_valid_len=pos + 1)
        y = self._proj(p, out.reshape(b, 1, c.num_heads * hd), "wo")
        return y, cache


class MLAttention:
    """Multi-head latent attention (deepseek-style): not ported."""

    def __init__(self, cfg):
        raise NotImplementedError("MLAttention is not ported (ROADMAP queue 1, item 12)")
