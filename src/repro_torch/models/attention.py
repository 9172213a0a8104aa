"""Attention mixers (port of ``repro/models/attention.py``: ``GQAttention``,
``MLAttention``, ``_attend`` and ``attend_chunked``).

Attention is plain jnp in the reference, not a Pallas kernel, so it is plain
torch here, in the reference's dtypes: the score product in the activation
dtype, then fp32 scores, the ``NEG_INF`` mask and an fp32 softmax, the
probabilities cast back for the value product. The full-sequence path
repeats K/V to the query heads before attention (q-chunked when S exceeds
``q_chunk``); decode reads the compact KV cache, a ring buffer for a local
``window``. ``MLAttention`` (deepseek's multi-head latent attention) caches
the latent ``c_kv`` and one shared ``k_rope`` instead of K/V, and decodes in
the absorbed form: scores and context in the latent space, each einsum
rounded to the activation dtype as the reference's. Cross-attention
(``GQAttention(cross=True)``) takes K/V from an encoder ``memory`` without
RoPE or a mask; its cache is the memory's K/V, computed once at prefill and
only read by decode.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.quant import QuantDBBWeight, dequantize_dbb
from repro_torch.core.vdbb import DBBWeight, dbb_decode
from repro_torch.models.common import (Param, apply_linear, current_rules, linear_def, rms_norm,
                                       rope, shard, spec_placements, write_slot_)

NEG_INF = -1e30
_NO_POS = 2**31 - 1  # an unfilled ring slot: later than every query


def _scale(d: int) -> float:
    """1 / sqrt(d) in fp32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _attend(q, k, v, q_pos, k_pos, *, window: int = 0, kv_valid_len=None):
    """q: (B,Sq,Kv,G,D); k/v: (B,Sk,Kv,D), v's D may differ (MLA: 192 for
    q and k, 128 for v); positions for causal masking. Returns
    (B,Sq,Kv,G,Dv)."""
    scale = _scale(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    s = shard(s, ("batch", "heads", None, "act_seq", None))
    mask = q_pos[:, None] >= k_pos[None, :]  # causal
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    if kv_valid_len is not None:
        mask &= k_pos[None, :] < kv_valid_len
    s = s.masked_fill(~mask, NEG_INF)
    p = shard(torch.softmax(s, dim=-1).to(v.dtype), ("batch", "heads", None, "act_seq", None))
    return shard(torch.einsum("bhgqk,bkhd->bqhgd", p, v), ("batch", "act_seq", "heads", None, None))


def _split(t, axis, *shape):
    """A projection's (B, S, H·D) output as (B, S, H, D), its feature dim
    first placed as ``axis`` (heads or kv) wants, so that the split keeps
    whole heads on a rank."""
    return shard(t, ("batch", "act_seq", axis)).reshape(*shape)

def _cross_positions(sq: int, sk: int, device):
    """The reference's cross-attention positions: every query at 1, every
    memory slot at 0, so the causal mask keeps every pair."""
    return (torch.ones(sq, dtype=torch.int64, device=device),
            torch.zeros(sk, dtype=torch.int64, device=device))


def _chunked(q, k, v, q_pos, k_pos, *, window=0, q_chunk=1024, kv_valid_len=None):
    b, sq, kvh, g, d = q.shape
    if sq <= q_chunk:
        return _attend(q, k, v, q_pos, k_pos, window=window, kv_valid_len=kv_valid_len)
    assert sq % q_chunk == 0, (sq, q_chunk)
    return torch.cat([
        _attend(q[:, i: i + q_chunk], k, v, q_pos[i: i + q_chunk], k_pos, window=window,
                kv_valid_len=kv_valid_len)
        for i in range(0, sq, q_chunk)], dim=1)


def attend_chunked(q, k, v, q_pos, k_pos, *, window=0, q_chunk=1024, kv_valid_len=None):
    """:func:`_attend` over q chunks of ``q_chunk`` queries. On DTensors
    split by batch and heads (not along a sequence) each rank attends its
    own heads of its own rows under ``local_map``: the same ops on local
    tensors, and no DTensor-level einsum, whose strategy search flattens
    the batch and head splits into strided shards (seconds an op on a 3-D
    mesh). K and V take q's placements dim for dim, replicated where q
    splits its group dim; their gradients there are partial sums."""
    run = functools.partial(_chunked, q_pos=q_pos, k_pos=k_pos, window=window, q_chunk=q_chunk,
                            kv_valid_len=kv_valid_len)
    if not isinstance(q, DTensor) or any(
            pl == Shard(1) for pl in (*q.placements, *getattr(k, "placements", ()))):
        return run(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl = tuple(q.placements)
    kv_pl = tuple(pl if pl in (Shard(0), Shard(2)) else Replicate() for pl in q_pl)
    kv_grad = tuple(Partial() if pl == Shard(3) else kp for pl, kp in zip(q_pl, kv_pl))
    fn = local_map(run, out_placements=(q_pl,),
                   in_placements=(q_pl, kv_pl, kv_pl), in_grad_placements=(q_pl, kv_grad, kv_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


# ---------------------------------------------------------------------------
# Context parallelism: the sequence split over 'model' where no head count
# divides it (``sharding/rules.py:attn_mode`` 'context')
# ---------------------------------------------------------------------------


def context_parallel(x, rule: str) -> bool:
    """Whether attention on ``x`` runs context-parallel: ``x`` a DTensor
    and the installed rules mapping ``rule`` ('act_seq' at train and
    prefill, 'cache_seq' at decode) to a mesh axis. On a mesh whose axis
    has one rank the same path runs and reduces to the one-device one."""
    rules = current_rules()
    return rules is not None and isinstance(x, DTensor) and rules.get(rule) is not None


def _split_dims(placements, dim: int) -> list:
    return [j for j, pl in enumerate(placements) if pl == Shard(dim)]


def attend_context(q, k, v, positions, *, num_heads, num_kv_heads, hd, theta, window=0,
                   q_chunk=1024):
    """Full-sequence attention with the queries split along the sequence
    ('act_seq' on the mesh). ``q`` (B, S, H·hd), ``k``/``v`` (B, S, kv·hd)
    are the projections' DTensors. K and V are gathered whole along the
    sequence (a rank's queries attend to every earlier key) and each rank
    runs :func:`attend_chunked` on its own queries, at their own positions,
    under ``local_map``: the head split and RoPE happen on local tensors, so
    no DTensor view splits a head dim the mesh does not divide. Returns
    ``(out, k, v)``: ``out`` (B, S, H·hd) split as ``q``; K and V (B, S,
    kv, hd) roped and whole along the sequence, as a prefill's cache keeps
    them. Gradients: ``q``'s split as ``q``; K's and V's partial sums over
    the ranks that split the queries, which the gather's backward
    reduce-scatters."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    batch = current_rules().get("batch")
    q = shard(q, ("batch", "act_seq", None))
    q_pl = tuple(q.placements)
    kv_pl = spec_placements((batch, None, None), mesh, k.shape, uneven="replicate")
    split = _split_dims(q_pl, 1)
    kv_grad = tuple(Partial() if j in split else pl for j, pl in enumerate(kv_pl))
    cache_pl = spec_placements((batch, None, None, None), mesh, k.shape + (1,),
                               uneven="replicate")
    s = q.shape[1]
    pos1 = positions[0] if positions.dim() == 2 else positions

    def local(ql, kl, vl):
        b, sl = ql.shape[:2]
        off = sum(mesh.get_local_rank(j) * sl for j in split)  # an even split: S % size == 0
        qpos = pos1[off: off + sl].to(ql.device)
        kpos = pos1.to(kl.device)
        ql = ql.reshape(b, sl, num_heads, hd)
        kl = kl.reshape(b, s, num_kv_heads, hd)
        vl = vl.reshape(b, s, num_kv_heads, hd)
        ql, kl = rope(ql, qpos, theta), rope(kl, kpos, theta)
        kc, vc = kl, vl
        g = num_heads // num_kv_heads
        if g > 1:  # K/V to the query heads, as the one-device path
            kl, vl = torch.repeat_interleave(kl, g, dim=2), torch.repeat_interleave(vl, g, dim=2)
        out = attend_chunked(ql.reshape(b, sl, num_heads, 1, hd), kl, vl, qpos, kpos,
                             window=window, q_chunk=q_chunk)
        return out.reshape(b, sl, num_heads * hd), kc, vc

    fn = local_map(local, out_placements=(q_pl, cache_pl, cache_pl),
                   in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl))


def decode_context(qg, k, v, pos, *, window=0):
    """One decode step's attention over a cache split along its sequence
    ('cache_seq' on the mesh): ``qg`` (B, 1, kv, G, hd), the cache's ``k``
    and ``v`` (B, cap, kv, hd) DTensors. Each rank scores its slice of the
    cache; the partial maxima, the softmax sums and the weighted values
    combine over the ranks that split the sequence (three all-reduces of
    (B, kv, G)-sized and (B, 1, kv, G, hd) tensors; no rank gathers the
    cache). With one rank along the split it is :func:`_attend` itself, bit
    for bit. Returns (B, 1, kv, G, hd)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    if window:
        raise NotImplementedError("a windowed ring cache split along its sequence (local "
                                  "attention) has no mesh path")
    mesh = k.device_mesh
    batch = current_rules().get("batch")
    kv_pl = tuple(k.placements)
    split = _split_dims(kv_pl, 1)
    q_pl = spec_placements((batch, None, None, None, None), mesh, qg.shape, uneven="replicate")
    cap = k.shape[1]
    n = 1
    for j in split:
        n *= mesh.size(j)
    if cap % n:
        raise ValueError(f"a cache of {cap} slots does not split evenly over {n} ranks")

    def reduce(t, op):
        for j in split:
            t = funcol.all_reduce(t, op, (mesh, j))
        return t

    def local(ql, kl, vl):
        sl = kl.shape[1]
        off = sum(mesh.get_local_rank(j) * sl for j in split)  # an even split: cap % n == 0
        kpos = off + torch.arange(sl, dtype=torch.int64, device=kl.device)
        p = pos.to(kl.device)
        if n == 1:
            return _attend(ql, kl, vl, p.reshape(1), kpos, kv_valid_len=p + 1)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", ql, kl).float() * _scale(ql.shape[-1])
        sc = sc.masked_fill(~(kpos <= p), NEG_INF)  # causal, and the valid slots
        top = reduce(sc.amax(dim=-1, keepdim=True), "max")
        e = torch.exp(sc - top)
        total = reduce(e.sum(dim=-1, keepdim=True), "sum")
        part = torch.einsum("bhgqk,bkhd->bqhgd", (e / total).to(vl.dtype), vl)
        return reduce(part.float(), "sum").to(vl.dtype)

    fn = local_map(local, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(qg, k, v)


@dataclasses.dataclass(frozen=True)
class GQAttention:
    cfg: "ModelConfig"  # noqa: F821
    window: int = 0  # 0 = global causal
    cross: bool = False  # K/V from an encoder memory, every slot attended

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

    def _grouped(self, q, b):
        """(B, 1, H, D) decode queries as (B, 1, kv, H / kv, D), the kv heads
        placed first so that a split keeps whole groups on a rank."""
        c = self.cfg
        q = shard(q, ("batch", None, "kv", None))
        return q.reshape(b, 1, c.num_kv_heads, c.num_heads // c.num_kv_heads, c.hd)

    # -------------------------------------------------------------- full
    def __call__(self, p, x, positions, memory=None):
        """Full-sequence forward. x: (B,S,d); a cross block takes K/V from
        ``memory`` (B, L, d). Returns (out, cache_kv)."""
        c = self.cfg
        hd = c.hd
        b, s, _ = x.shape
        kv_src = memory if self.cross else x
        sk = kv_src.shape[1]
        q, k, v = (self._proj(p, x, "wq", "bq"), self._proj(p, kv_src, "wk", "bk"),
                   self._proj(p, kv_src, "wv", "bv"))
        if not self.cross and context_parallel(q, "act_seq"):
            out, k_cache, v_cache = attend_context(
                q, k, v, positions, num_heads=c.num_heads, num_kv_heads=c.num_kv_heads, hd=hd,
                theta=c.rope_theta, window=self.window, q_chunk=c.q_chunk)
            return self._proj(p, out, "wo"), {"k": k_cache, "v": v_cache}
        q = _split(q, "heads", b, s, c.num_heads, hd)
        k = _split(k, "kv", b, sk, c.num_kv_heads, hd)
        v = _split(v, "kv", b, sk, c.num_kv_heads, hd)
        if not self.cross:
            q = rope(q, positions, c.rope_theta)
            k = rope(k, positions, c.rope_theta)
        k_cache, v_cache = k, v  # the cache keeps the compact kv-head layout
        g = c.num_heads // c.num_kv_heads
        if g > 1:  # expand KV to the query heads before attention, as the reference
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        q = shard(q, ("batch", "act_seq", "heads", None))
        k = shard(k, ("batch", "act_seq", "heads", None))
        v = shard(v, ("batch", "act_seq", "heads", None))
        qg = q.reshape(b, s, c.num_heads, 1, hd)
        if self.cross:  # every query sees every memory slot
            qp, kp = _cross_positions(s, sk, x.device)
            out = attend_chunked(qg, k, v, qp, kp, q_chunk=c.q_chunk)
        else:
            pos1 = positions[0] if positions.dim() == 2 else positions
            out = attend_chunked(qg, k, v, pos1, pos1, window=self.window, q_chunk=c.q_chunk)
        y = self._proj(p, out.reshape(b, s, c.num_heads * hd), "wo")
        return y, {"k": k_cache, "v": v_cache}

    # ------------------------------------------------------------ decode
    def init_cache(self, batch, max_len, dtype, device=None):
        c = self.cfg
        cap = min(self.window, max_len) if self.window else max_len
        if self.cross:
            cap = c.cross_len
        shape = (batch, cap, c.num_kv_heads, c.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, p, x, cache, pos):
        """x: (B,1,d); ``pos`` the current position, a 0-d int64 tensor on
        x's device. The slot, the ring's positions and the valid length are
        device ops on it, so a CUDA graph of the step replays at any
        position. Writes the new K/V into ``cache`` in place (the reference
        returns an updated copy) and returns (y, cache). A cross block runs
        only ``wq`` and ``wo``: it reads the memory's K/V from ``cache``
        whole and does not depend on ``pos``."""
        c = self.cfg
        hd = c.hd
        b = x.shape[0]
        if self.cross:  # K/V were computed at prefill: read, never written
            q = _split(self._proj(p, x, "wq", "bq"), "heads", b, 1, c.num_heads, hd)
            out = attend_chunked(self._grouped(q, b), cache["k"], cache["v"],
                                 *_cross_positions(1, cache["k"].shape[1], x.device))
            return self._proj(p, out.reshape(b, 1, c.num_heads * hd), "wo"), cache
        posv = pos.reshape(1, 1).expand(b, 1)
        q = rope(_split(self._proj(p, x, "wq", "bq"), "heads", b, 1, c.num_heads, hd), posv,
                 c.rope_theta)
        k_new = rope(_split(self._proj(p, x, "wk", "bk"), "kv", b, 1, c.num_kv_heads, hd), posv,
                     c.rope_theta)
        v_new = _split(self._proj(p, x, "wv", "bv"), "kv", b, 1, c.num_kv_heads, hd)
        cap = cache["k"].shape[1]
        slot = pos % cap if self.window else pos.clamp(max=cap - 1)
        write_slot_(cache["k"], slot.reshape(1), k_new)
        write_slot_(cache["v"], slot.reshape(1), v_new)
        qg = self._grouped(q, b)
        if context_parallel(cache["k"], "cache_seq"):
            out = decode_context(qg, cache["k"], cache["v"], pos, window=self.window)
            return self._proj(p, out.reshape(b, 1, c.num_heads * hd), "wo"), cache
        kpos = torch.arange(cap, dtype=torch.int64, device=x.device)
        if self.window:  # ring buffer: the absolute position of each slot
            base = pos - slot
            kpos = torch.where(kpos <= slot, base + kpos, base - cap + kpos)
            kpos = torch.where(kpos < 0, torch.full_like(kpos, _NO_POS), kpos)
        out = attend_chunked(qg, cache["k"], cache["v"], pos.reshape(1), kpos, window=self.window,
                             kv_valid_len=pos + 1)
        y = self._proj(p, out.reshape(b, 1, c.num_heads * hd), "wo")
        return y, cache


@dataclasses.dataclass(frozen=True)
class MLAttention:
    """Multi-head latent attention (deepseek-style). The query goes through
    a LoRA (``wq_a``, ``q_norm``, ``wq_b``) when ``q_lora_rank`` is set;
    ``wkv_a`` gives the latent ``c_kv`` (``kv_lora_rank`` wide, normed) and
    one RoPE key ``k_rope`` shared by all heads, and ``wkv_b`` expands the
    latent to each head's ``k_nope`` and ``v``. The cache holds ``c_kv``
    and ``k_rope`` (B, S, r) and (B, S, qk_rope_dim)."""

    cfg: "ModelConfig"  # noqa: F821

    def defs(self):
        c = self.cfg
        dbb = c.dbb
        qd = c.qk_nope_dim + c.qk_rope_dim
        d = {}
        if c.q_lora_rank:
            d["wq_a"] = linear_def(c.d_model, c.q_lora_rank, "embed", None, dbb=dbb)
            d["q_norm"] = Param((c.q_lora_rank,), (None,), "ones")
            d["wq_b"] = linear_def(c.q_lora_rank, c.num_heads * qd, None, "heads", dbb=dbb)
        else:
            d["wq"] = linear_def(c.d_model, c.num_heads * qd, "embed", "heads", dbb=dbb)
        d["wkv_a"] = linear_def(c.d_model, c.kv_lora_rank + c.qk_rope_dim, "embed", None,
                                dbb=dbb)
        d["kv_norm"] = Param((c.kv_lora_rank,), (None,), "ones")
        d["wkv_b"] = linear_def(c.kv_lora_rank, c.num_heads * (c.qk_nope_dim + c.v_head_dim),
                                None, "heads", dbb=dbb)
        d["wo"] = linear_def(c.num_heads * c.v_head_dim, c.d_model, "heads", "embed", dbb=dbb)
        return d

    def _proj(self, p, x, name):
        return apply_linear(x, p[name], aq=p.get(f"{name}_aq"), name=name)

    def _q(self, p, x):
        """(B, S, H, qk_nope_dim + qk_rope_dim), before RoPE."""
        c = self.cfg
        b, s, _ = x.shape
        if c.q_lora_rank:
            q = self._proj(p, rms_norm(self._proj(p, x, "wq_a"), p["q_norm"]), "wq_b")
        else:
            q = self._proj(p, x, "wq")
        return _split(q, "heads", b, s, c.num_heads, c.qk_nope_dim + c.qk_rope_dim)

    def _latent(self, p, x, positions):
        """The normed latent ``c_kv`` (B, S, r) and the roped ``k_rope``
        (B, S, 1, qk_rope_dim), RoPE applied to it as one head."""
        c = self.cfg
        b, s, _ = x.shape
        kv_a = self._proj(p, x, "wkv_a")
        c_kv = rms_norm(kv_a[..., : c.kv_lora_rank], p["kv_norm"])
        k_rope = rope(kv_a[..., c.kv_lora_rank:].reshape(b, s, 1, c.qk_rope_dim), positions,
                      c.rope_theta)
        return c_kv, k_rope

    # -------------------------------------------------------------- full
    def __call__(self, p, x, positions):
        """Full-sequence forward. x: (B,S,d). Returns (out, {"c_kv",
        "k_rope"}). K is ``k_nope`` beside ``k_rope`` broadcast to every
        head, so the scores run over qk_nope_dim + qk_rope_dim and are
        scaled by its root; the context is v_head_dim wide."""
        c = self.cfg
        b, s, _ = x.shape
        q = self._q(p, x)
        q_nope, q_rope = q[..., : c.qk_nope_dim], rope(q[..., c.qk_nope_dim:], positions,
                                                       c.rope_theta)
        c_kv, k_rope = self._latent(p, x, positions)
        kv = _split(self._proj(p, c_kv, "wkv_b"), "heads", b, s, c.num_heads,
                    c.qk_nope_dim + c.v_head_dim)
        k_nope, v = kv[..., : c.qk_nope_dim], kv[..., c.qk_nope_dim:]
        k = torch.cat([k_nope, k_rope.expand(b, s, c.num_heads, c.qk_rope_dim)], dim=-1)
        qf = shard(torch.cat([q_nope, q_rope], dim=-1), ("batch", "act_seq", "heads", None))
        k = shard(k, ("batch", "act_seq", "heads", None))
        qf = qf.reshape(b, s, c.num_heads, 1, -1)
        pos1 = positions[0] if positions.dim() == 2 else positions
        out = attend_chunked(qf, k, v, pos1, pos1, q_chunk=c.q_chunk)
        y = self._proj(p, out.reshape(b, s, c.num_heads * c.v_head_dim), "wo")
        return y, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}

    # ------------------------------------------------------------ decode
    def init_cache(self, batch, max_len, dtype, device=None):
        c = self.cfg
        return {"c_kv": torch.zeros((batch, max_len, c.kv_lora_rank), dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, c.qk_rope_dim), dtype=dtype,
                                      device=device)}

    def absorbed(self, wkv_b, dtype):
        """The absorbed decode's weights from one layer's ``wkv_b``: (w_uk
        (r, H, qk_nope_dim), w_uv (r, H, v_head_dim)) in ``dtype``, each
        contiguous. A compressed weight is decoded to dense first (an int8
        one dequantized to fp32 values before), as the reference does
        inside every decode step: these are its values, bit for bit."""
        c = self.cfg
        if isinstance(wkv_b, QuantDBBWeight):
            wkv_b = dequantize_dbb(wkv_b)
        if isinstance(wkv_b, DBBWeight):
            wkv_b = dbb_decode(wkv_b)
        w = wkv_b.reshape(c.kv_lora_rank, c.num_heads, c.qk_nope_dim + c.v_head_dim)
        return (w[..., : c.qk_nope_dim].to(dtype).contiguous(),
                w[..., c.qk_nope_dim:].to(dtype).contiguous())

    def decode(self, p, x, cache, pos, absorbed=None):
        """Absorbed decode: x (B,1,d), ``pos`` a 0-d int64 tensor on x's
        device. Writes the new ``c_kv`` and ``k_rope`` into ``cache`` in
        place at slot ``pos`` (clamped to the capacity, as the reference's
        ``dynamic_update_slice``), then scores the latent cache with the
        query absorbed through ``w_uk`` and contracts the context through
        ``w_uv``; every einsum rounds to x's dtype, and the two scores are
        summed in it before the fp32 scale, mask and softmax. The mask is
        ``slot <= pos`` over the whole capacity. ``absorbed`` is
        :meth:`absorbed` of ``p["wkv_b"]`` decoded once by the caller;
        None decodes it here. Returns (y, cache)."""
        c = self.cfg
        b = x.shape[0]
        dt = x.dtype
        posv = pos.reshape(1, 1).expand(b, 1)
        q = self._q(p, x)
        q_nope, q_rope = q[..., : c.qk_nope_dim], rope(q[..., c.qk_nope_dim:], posv,
                                                       c.rope_theta)
        c_kv, k_rope = self._latent(p, x, posv)
        cap = cache["c_kv"].shape[1]
        slot = pos.clamp(max=cap - 1).reshape(1)
        write_slot_(cache["c_kv"], slot, c_kv)
        write_slot_(cache["k_rope"], slot, k_rope[:, :, 0])
        w_uk, w_uv = absorbed if absorbed is not None else self.absorbed(p["wkv_b"], dt)
        ckv = shard(cache["c_kv"].to(dt), ("batch", "cache_seq", None))
        krp = cache["k_rope"].to(dt)
        q_c = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk.to(dt))
        s_lat = torch.einsum("bqhr,bsr->bhqs", q_c, ckv)
        s_rope = torch.einsum("bqhp,bsp->bhqs", q_rope, krp)
        s = (s_lat + s_rope).float() * _scale(c.qk_nope_dim + c.qk_rope_dim)
        kpos = torch.arange(cap, dtype=torch.int64, device=x.device)
        s = s.masked_fill(~(kpos <= pos), NEG_INF)
        pr = torch.softmax(s, dim=-1).to(dt)
        ctx = torch.einsum("bhqs,bsr->bqhr", pr, ckv)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.to(dt))
        y = self._proj(p, out.reshape(b, 1, c.num_heads * c.v_head_dim), "wo")
        return y, cache
