"""The decoder LM (port of ``repro/models/model.py:LM``).

Covers every family of the registry: ``family='dense'`` and ``'moe'``
(``MoEMLP``) with ``mixer='gqa'`` or ``mixer='mla'`` (``MLAttention``:
deepseek's latent cache and absorbed decode), ``'hybrid'`` (RG-LRU ``rec``
blocks beside ``local`` attention, recurrentgemma's tied embeddings,
embedding scale and logit soft-cap), ``'ssm'`` (``mixer='rwkv6'``: RWKV6
blocks of time and channel mix), ``'vlm'`` (``frontend='vision'``:
precomputed vision embeddings written over the first positions) and
``'audio'`` (``frontend='audio'``: the sum of ``num_codebooks`` codebook
embeddings a position, a head over every codebook's vocabulary, and
cross-attention to a text ``memory`` after each block's self-attention).
The frontends are stubs in the reference too: their encoders' outputs are
inputs. :func:`lm_defs` describes each config's parameter tree.

The parameter tree is the reference's: ``embed``, ``layers`` stacked over
layer groups (a leading axis on every leaf, compressed ones included),
``tail`` for layers left over by the pattern, ``final_norm``, ``lm_head``
(none when the embeddings are tied), and the ``<leaf>_aq`` calibration
siblings that :meth:`LM.quantize` adds. The model holds it (:meth:`state`)
and converts it in place (:meth:`compress`, :meth:`quantize`,
:meth:`constrain`). Layer groups run as a Python loop, as the reference's
unscanned forward does. Training runs the same forward under autograd
(:meth:`loss`, ``train/step.py``) and honours ``remat`` as the reference's
scanned body does: ``'full'`` checkpoints each layer group
(``torch.utils.checkpoint``, non-reentrant), ``'dots'`` keeps the group's
matmul outputs and recomputes the rest (a selective checkpoint policy, JAX's
``dots_with_no_batch_dims_saveable``), ``'none'`` keeps everything; the
values are the same bits either way. Beside the tree, never in it, the model
keeps each MLA block's ``wkv_b`` decoded to dense for the absorbed decode
(the reference decodes it inside every step), rebuilt whenever the tree is
set or converted.

The paper's technique runs end to end: every projection is DBB-tagged,
:meth:`compress` encodes each into the compressed layout (values (L, nb,
nnz, N)), and ``apply_linear`` runs the tc kernel over the compressed K
(bf16 or fp32 operands), or on the int8 tensor cores after
:meth:`quantize`. The MoE's 4-D expert stacks carry no DBB tag and stay
dense, as in the reference. :meth:`plan` freezes int8 prefill of a text
decoder into a :class:`~repro_torch.models.plan.ModelPlan`, one CUDA graph
per signature; it refuses a frontend or cross-attention, as the
reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.act_sparsity import act_scope, collect_activations, collecting
from repro_torch.core.quant import QMAX, QuantDBBWeight, as_f32, quantize_dbb
from repro_torch.core.sparse_linear import PruneSchedule, scheduled_fmt
from repro_torch.core.vdbb import DBBWeight, dbb_encode, dbb_mask
from repro_torch.models.attention import GQAttention, MLAttention
from repro_torch.models.common import (Param, apply_linear, dbb_leaves, init_params,
                                       layer_norm, rms_norm, sharded_embed_lookup, stage_linear,
                                       tree_get, tree_set, tree_slice, tree_unstack)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import DenseMLP, MoEMLP
from repro_torch.models.recurrent import RGLRUBlock, RWKV6Block


def check_plannable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config :meth:`LM.plan` cannot
    freeze, as the reference's ``LM.plan``: a frontend's or a cross
    block's side inputs (vision embeddings, memory) have no place in a
    single-input chain."""
    if cfg.cross_attn or cfg.frontend:
        raise NotImplementedError(
            f"LM.plan supports decoder-only text models; {cfg.name}: cross_attn or "
            f"frontend={cfg.frontend!r} needs per-call side inputs")


REMAT = ("none", "full", "dots")
# the products without batch dimensions: what ``x @ w`` of a projection lowers to
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots():
    """The selective checkpoint context of ``remat='dots'``: save the
    outputs of the group's matmuls without batch dimensions, recompute
    everything else, as JAX's ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def mixer_for(cfg: ModelConfig, kind: str):
    """The mixer of a block of ``kind``: MLA for ``attn`` blocks of an MLA
    config, as the reference's ``LM._mixer``."""
    if kind == "attn":
        return MLAttention(cfg) if cfg.mixer == "mla" else GQAttention(cfg)
    if kind == "local":
        return GQAttention(cfg, window=cfg.local_window)
    if kind == "rec":
        return RGLRUBlock(cfg)
    if kind == "rwkv":
        return RWKV6Block(cfg)
    raise ValueError(kind)


def lm_defs(cfg: ModelConfig) -> dict:
    """The parameter defs tree of ``cfg``'s LM, the reference's
    ``LM.defs()``, for every registry config, the cross-attention blocks'
    ``norm_x`` and ``cross`` and the audio codebooks' embedding and head
    included."""
    def norm():
        d = {"g": Param((cfg.d_model,), (None,), "ones")}
        if cfg.norm == "layernorm":
            d["b"] = Param((cfg.d_model,), (None,), "zeros")
        return d

    def block(kind):
        d = {"norm1": norm(), "mixer": mixer_for(cfg, kind).defs(), "norm2": norm()}
        if kind == "rwkv":  # RWKV6's channel mix is its MLP
            return d
        d["mlp"] = (MoEMLP(cfg) if cfg.is_moe else DenseMLP(cfg)).defs()
        if cfg.cross_attn:  # the same leaves as self-attention's
            d["norm_x"], d["cross"] = norm(), GQAttention(cfg).defs()
        return d

    def stack(d):
        if isinstance(d, Param):
            return dataclasses.replace(d, shape=(cfg.num_groups,) + d.shape,
                                       axes=("layers",) + d.axes)
        return {k: stack(v) for k, v in d.items()}

    out = {
        "embed": Param((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), "scaled"),
        "layers": stack({f"b{i}": block(k) for i, k in enumerate(cfg.pattern)}),
        "final_norm": norm(),
    }
    if cfg.tail_pattern:
        out["tail"] = {f"t{i}": block(k) for i, k in enumerate(cfg.tail_pattern)}
    audio = cfg.frontend == "audio"
    if not cfg.tie_embeddings:
        vocab = cfg.num_codebooks * cfg.codebook_vocab if audio else cfg.padded_vocab
        out["lm_head"] = Param((cfg.d_model, vocab), ("embed", "vocab"), "scaled")
    if audio:
        out["embed"] = Param((cfg.num_codebooks, cfg.codebook_vocab, cfg.d_model),
                             (None, "vocab", "embed"), "scaled")
    return out


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.params: Optional[dict] = None
        self._absorbed: dict = {}  # MLA blocks' decoded wkv_b (:meth:`_absorb`)

    # ------------------------------------------------------------- defs
    def _mixer(self, kind):
        return mixer_for(self.cfg, kind)

    def _mlp(self):
        return MoEMLP(self.cfg) if self.cfg.is_moe else DenseMLP(self.cfg)

    def _apply_norm(self, p, x):
        if self.cfg.norm == "layernorm":
            return layer_norm(x, p["g"], p["b"])
        return rms_norm(x, p["g"])

    def defs(self):
        return lm_defs(self.cfg)

    # ------------------------------------------------------------ state
    def init(self, generator: torch.Generator, device, *, compress: bool = False) -> "LM":
        """Seeded weights from ``generator``, drawn on ``device`` (the
        generator's own) in the config's param dtype. With ``compress`` every
        DBB-tagged leaf is encoded as soon as it is drawn, so the dense tree
        never exists whole. In place."""
        fn = None
        if compress and self.cfg.dbb is not None and self.cfg.serve_compressed:
            def fn(path, p, w):
                return self._encode(w, p.dbb) if p.dbb is not None else w
        self.params = init_params(self.defs(), generator, self.cfg.param_dtype, device,
                                  leaf_fn=fn)
        return self._absorb()

    def load_params(self, tree: dict) -> "LM":
        """Adopt a parameter tree (``interop.params_from_numpy``'s output)."""
        self.params = tree
        return self._absorb()

    def _absorb(self) -> "LM":
        """Decode every MLA block's ``wkv_b`` once for the absorbed decode:
        ``MLAttention.absorbed`` of each layer group's weight in the
        compute dtype, kept beside the tree (``self._absorbed``: (``b{i}``,
        group) -> (w_uk, w_uv)), so the tree stays the reference's. Every
        change of the tree calls it. (A tail block, which no MLA config
        has, would decode its weight inside each step, as the reference.)"""
        c = self.cfg
        self._absorbed = {}
        if c.mixer != "mla":
            return self
        mla = MLAttention(c)
        for i, kind in enumerate(c.pattern):
            if kind == "attn":
                w = self.params["layers"][f"b{i}"]["mixer"]["wkv_b"]
                for g in range(c.num_groups):
                    self._absorbed[f"b{i}", g] = mla.absorbed(w[g], c.compute_dtype)
        return self

    def state(self) -> dict:
        """The parameter tree, the reference's ``params``."""
        return self.params

    @property
    def device(self) -> torch.device:
        e = self.params["embed"]
        return e.device

    # -------------------------------------------------------- embeddings
    def _embed(self, tokens, vision_embeds=None, params=None):
        """(B, S) tokens, or (B, S, num_codebooks) audio tokens, -> (B, S,
        d) in the compute dtype. Audio sums the codebooks' rows in codebook
        order in the table's dtype, then casts, as the reference's
        ``sum(embs).astype(...)``; ``vision_embeds`` (B, nv, d) are cast
        and written over positions 0 … nv - 1 after the embedding scale."""
        c = self.cfg
        table = (self.params if params is None else params)["embed"]
        tokens = tokens.to(table.device)
        if c.frontend == "audio":
            h = table[0].index_select(0, tokens[..., 0].reshape(-1))
            for i in range(1, c.num_codebooks):
                h = h + table[i].index_select(0, tokens[..., i].reshape(-1))
            h = h.reshape(*tokens.shape[:-1], table.shape[-1]).to(c.compute_dtype)
        else:
            h = sharded_embed_lookup(table, tokens, c.compute_dtype)
        if c.embed_scale:  # sqrt(d_model) in fp32, rounded to the activation dtype
            h = h * float(torch.tensor(math.sqrt(c.d_model), dtype=torch.float32).to(h.dtype))
        if c.frontend == "vision" and vision_embeds is not None:
            nv = vision_embeds.shape[1]
            if nv > h.shape[1]:
                raise ValueError(f"{c.name}: {nv} vision embeddings do not fit a prompt of "
                                 f"{h.shape[1]} tokens")
            h = torch.cat([vision_embeds.to(h.device, c.compute_dtype), h[:, nv:]], dim=1)
        return h

    def _logits(self, x, params=None):
        c = self.cfg
        params = self.params if params is None else params
        if c.tie_embeddings:  # a dense product with the table, as the reference's
            logits = x @ params["embed"].t().to(x.dtype)
        else:
            logits = apply_linear(x, params["lm_head"], name="lm_head")
        if c.logit_softcap:  # tanh(l / cap) * cap, each op rounding in l's dtype
            logits = torch.tanh(logits / as_f32(c.logit_softcap, x.device)) * c.logit_softcap
        return logits

    # ------------------------------------------------------------ blocks
    def _apply_block(self, kind, p, x, positions, memory=None):
        """Full-sequence block. Returns (x, the block's cache: K/V, or the
        recurrent state; with cross-attention ``{"self": …, "cross": the
        memory's K/V}``)."""
        h = self._apply_norm(p["norm1"], x)
        if kind == "rwkv":  # no act scope of its own, as the reference
            mixer, zero = self._mixer(kind), x.new_zeros((x.shape[0], x.shape[-1]))
            y, cache = mixer.time_mix(p["mixer"]["tm"], h, zero)
            x = x + y
            y2, cm_shift = mixer.channel_mix(p["mixer"]["cm"], self._apply_norm(p["norm2"], x), zero)
            return x + y2, {**cache, "cm_shift": cm_shift}
        with act_scope("mixer"):
            y, cache = self._mixer(kind)(p["mixer"], h, positions)
        x = x + y
        if self.cfg.cross_attn:
            with act_scope("cross"):
                y, cross = GQAttention(self.cfg, cross=True)(
                    p["cross"], self._apply_norm(p["norm_x"], x), positions, memory=memory)
            x = x + y
            cache = {"self": cache, "cross": cross}
        with act_scope("mlp"):
            y2 = self._mlp()(p["mlp"], self._apply_norm(p["norm2"], x))
        return x + y2, cache

    def _apply_block_decode(self, kind, p, x, cache, pos, absorbed=None):
        """One block's decode step; ``absorbed``: an MLA block's decoded
        ``wkv_b`` (:meth:`_absorb`)."""
        h = self._apply_norm(p["norm1"], x)
        if kind == "rwkv":
            mixer = self._mixer(kind)
            x = x + mixer.time_mix_decode(p["mixer"]["tm"], h, cache)[0]
            return x + mixer.channel_mix_decode(p["mixer"]["cm"],
                                                self._apply_norm(p["norm2"], x), cache), cache
        mixer = self._mixer(kind)
        own = cache["self"] if self.cfg.cross_attn else cache
        if isinstance(mixer, MLAttention):
            y, _ = mixer.decode(p["mixer"], h, own, pos, absorbed)
        else:
            y, _ = mixer.decode(p["mixer"], h, own, pos)
        x = x + y
        if self.cfg.cross_attn:
            x = x + GQAttention(self.cfg, cross=True).decode(
                p["cross"], self._apply_norm(p["norm_x"], x), cache["cross"], pos)[0]
        y2 = self._mlp()(p["mlp"], self._apply_norm(p["norm2"], x))
        return x + y2, cache

    # ----------------------------------------------------------- forward
    def forward(self, tokens, *, memory=None, vision_embeds=None, return_cache: bool = False,
                collect_act_stats: bool = False, params=None):
        """Full-sequence forward (prefill) of (B, S) tokens ((B, S,
        num_codebooks) for audio) -> logits (B, S, padded_vocab; audio:
        num_codebooks · codebook_vocab); ``memory`` (B, cross_len, d) feeds
        the cross blocks, cast to the compute dtype once; ``vision_embeds``
        (B, nv, d) replace the first nv positions' embeddings. With
        ``return_cache`` also every block's cache (``{"groups": {"b{i}":
        …}, "tail": …}``, groups stacked): K/V (``k``, ``v``) of an
        attention block (``{"self": K/V, "cross": the memory's K/V}`` with
        cross-attention), the latent ``c_kv`` and ``k_rope`` of an MLA one,
        ``h`` and ``conv`` of an RG-LRU block, ``s``, ``shift`` and
        ``cm_shift`` of an RWKV6 one. ``collect_act_stats=True`` appends
        the per-GEMM ``ActStats`` that ``apply_linear`` records:
        ``(logits[, cache], stats)``. ``params``: a tree to run in place of
        the model's (the loss's, under autograd). While autograd records,
        each layer group runs under the config's ``remat`` policy (not
        while stats are collected, as the reference)."""
        if collect_act_stats:
            with collect_activations() as col:
                out = self.forward(tokens, memory=memory, vision_embeds=vision_embeds,
                                   return_cache=return_cache, params=params)
            out = out if isinstance(out, tuple) else (out,)
            return (*out, col.stats)
        c = self.cfg
        params = self.params if params is None else params
        h = self._embed(tokens, vision_embeds, params)
        b, s, _ = h.shape
        if memory is not None:
            memory = memory.to(h.device, c.compute_dtype)
        positions = torch.arange(s, device=h.device).expand(b, s)

        def group_body(h, gp):
            caches = {}
            for i, kind in enumerate(c.pattern):
                with act_scope(f"b{i}"):
                    h, caches[f"b{i}"] = self._apply_block(kind, gp[f"b{i}"], h, positions,
                                                           memory)
            return h, caches

        body = self._remat(group_body)
        groups = []
        for g, gp in enumerate(tree_unstack(params["layers"], c.num_groups)):
            with act_scope(f"g{g}"):
                h, caches = body(h, gp)
            groups.append(caches)
        tails = {}
        for i, kind in enumerate(c.tail_pattern):
            with act_scope("tail"), act_scope(f"t{i}"):
                h, tails[f"t{i}"] = self._apply_block(kind, params["tail"][f"t{i}"], h,
                                                      positions, memory)
        logits = self._logits(self._apply_norm(params["final_norm"], h), params)
        if not return_cache:
            return logits
        cache = {"groups": _stack(groups)}
        if tails:
            cache["tail"] = tails
        return logits, cache

    def _remat(self, body):
        """``body(h, group_params)`` under the config's remat policy while
        autograd records; as it is otherwise, and while stats are collected
        (the recompute would record them twice)."""
        c = self.cfg
        if c.remat not in REMAT:
            raise ValueError(f"remat={c.remat!r}: one of {REMAT}")
        if c.remat == "none" or not torch.is_grad_enabled() or collecting():
            return body
        from torch.utils.checkpoint import checkpoint

        kw = {"context_fn": _save_dots} if c.remat == "dots" else {}
        return lambda h, gp: checkpoint(body, h, gp, use_reentrant=False, **kw)

    # -------------------------------------------------------------- loss
    def loss(self, batch: dict, params=None):
        """The next-token loss of ``batch`` (tensors: ``tokens``, ``labels``,
        optionally ``loss_mask``, ``memory``, ``vision_embeds``), the
        reference's: an fp32 logsumexp less the label's logit taken through
        a one-hot sum; audio logits reshaped to (B, S, num_codebooks,
        codebook_vocab) and the loss averaged over the codebooks; masked
        positions out of the mean. ``params``: the tree to differentiate
        (the model's by default). Returns ``(loss, {"loss", "nll_mean"})``."""
        c = self.cfg
        side = {k: batch[k] for k in ("memory", "vision_embeds") if k in batch}
        logits = self.forward(batch["tokens"], params=params, **side)
        labels = batch["labels"].to(logits.device)
        mask = batch.get("loss_mask")
        if c.frontend == "audio":
            b, s, _ = logits.shape
            logits = logits.reshape(b, s, c.num_codebooks, c.codebook_vocab)
            vocab = c.codebook_vocab
        else:
            vocab = logits.shape[-1]
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        iota = torch.arange(vocab, dtype=labels.dtype, device=labels.device)
        onehot = (labels[..., None] == iota).float()
        nll = lse - (logits * onehot).sum(dim=-1)
        if c.frontend == "audio":
            nll = nll.mean(dim=-1)
        if mask is not None:
            mask = mask.to(nll.device, torch.float32)
            nll = nll * mask
            denom = torch.clamp(mask.sum(), min=1.0)
        else:
            denom = float(nll.numel())
        loss = nll.sum() / denom
        return loss, {"loss": loss, "nll_mean": loss}

    # ------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int):
        """Zero caches, stacked over groups for the pattern's blocks: K/V
        (G, B, cap, kv, hd), ``cap`` being ``max_len`` or a ``local``
        block's window (a ring); an MLA block's ``c_kv`` (G, B, max_len, r)
        and ``k_rope`` (G, B, max_len, qk_rope_dim); a recurrent block's
        fixed-size state; with cross-attention an attention block's is
        ``{"self": …, "cross": K/V of cross_len slots}``."""
        c = self.cfg
        dt, dev = c.compute_dtype, self.device

        def block(kind):
            own = self._mixer(kind).init_cache(batch_size, max_len, dt, dev)
            if not c.cross_attn or kind == "rwkv":
                return own
            return {"self": own,
                    "cross": GQAttention(c, cross=True).init_cache(batch_size, max_len, dt, dev)}

        out = {"groups": _stack([{f"b{i}": block(k) for i, k in enumerate(c.pattern)}
                                 for _ in range(c.num_groups)])}
        if c.tail_pattern:
            out["tail"] = {f"t{i}": block(k) for i, k in enumerate(c.tail_pattern)}
        return out

    def decode_step(self, cache, tokens, pos):
        """One-token decode: tokens (B, 1) ((B, 1, num_codebooks) for
        audio), ``pos`` their position, a 0-d int64 tensor on the model's
        device (the reference's traced ``jnp.int32``), or an int turned into
        one. Every use of it is a device op, so a CUDA graph of the step
        replays at any position. Returns (logits (B, 1, vocab), cache), the
        cache (K/V and recurrent state) updated in place; cross blocks read
        the memory's K/V that the prefill left in the cache, so the step
        takes no memory."""
        c = self.cfg
        params = self.params
        pos = torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        h = self._embed(tokens)
        for g in range(c.num_groups):
            gp = tree_slice(params["layers"], g)
            gc = tree_slice(cache["groups"], g)
            for i, kind in enumerate(c.pattern):
                h, _ = self._apply_block_decode(kind, gp[f"b{i}"], h, gc[f"b{i}"], pos,
                                                self._absorbed.get((f"b{i}", g)))
        for i, kind in enumerate(c.tail_pattern):
            h, _ = self._apply_block_decode(kind, params["tail"][f"t{i}"], h,
                                            cache["tail"][f"t{i}"], pos)
        return self._logits(self._apply_norm(params["final_norm"], h)), cache

    # -------------------------------------------- the paper's technique
    def constrain(self, step=None, schedule: Optional[PruneSchedule] = None) -> "LM":
        """In place: project every DBB-tagged dense leaf onto its constraint,
        with a schedule and a step onto the annealed bound
        ``schedule.nnz_at(step)`` (the reference switches between the bounds
        with ``lax.switch``). A stacked leaf is projected slice by slice
        along its leading axes, which is what the reference's ``vmap``
        computes; a compressed leaf is skipped. The pruned entries become
        zero in place, so the leaves stay the tensors autograd and the
        optimizer hold."""
        with torch.no_grad():
            for path, pdef in dbb_leaves(self.defs()):
                w = tree_get(self.params, path)
                if not isinstance(w, torch.Tensor):
                    continue  # already compressed
                fmt = scheduled_fmt(pdef.dbb, step, schedule)
                if fmt.is_dense:
                    continue  # nnz == bz keeps every entry
                for sl in w.view(-1, *w.shape[-2:]):
                    sl.masked_fill_(~dbb_mask(sl, fmt), 0)
        return self._absorb()

    @staticmethod
    def _encode(w, fmt):
        if not isinstance(w, torch.Tensor) or w.dim() > 3:
            return w
        return dbb_encode(w, fmt, prune=True)

    def compress(self) -> "LM":
        """In place: every DBB-tagged weight becomes a compressed DBBWeight
        (stacked leaves encoded group by group)."""
        for path, pdef in dbb_leaves(self.defs()):
            self.params = tree_set(self.params, path,
                                   self._encode(tree_get(self.params, path), pdef.dbb))
        return self._absorb()

    @staticmethod
    def _stat_absmax(stats) -> dict:
        """name -> max absmax over the calibration records."""
        out = {}
        for st in stats or []:
            name = getattr(st, "name", "")
            amax = float(getattr(st, "absmax", 0.0))
            if name and amax > 0.0:
                out[name] = max(out.get(name, 0.0), amax)
        return out

    def _leaf_act_scales(self, path, absmax):
        """The calibrated per-tensor act scale(s) of one DBB leaf, or None:
        an (L,) tensor for a stacked leaf (one scoped name ``g{g}.…`` per
        group), a 0-d tensor for a tail leaf."""
        if path[0] == "layers":
            suffix = ".".join(path[1:])
            scales = []
            for g in range(self.cfg.num_groups):
                amax = absmax.get(f"g{g}.{suffix}")
                if amax is None:
                    return None
                scales.append(amax / QMAX)
            return torch.tensor(scales, dtype=torch.float32, device=self.device)
        amax = absmax.get(".".join(path))
        if amax is None:
            return None
        return torch.tensor(amax / QMAX, dtype=torch.float32, device=self.device)

    def quantize(self, stats=None) -> "LM":
        """In place: INT8-quantize every compressed DBBWeight leaf. ``stats``
        (from ``forward(..., collect_act_stats=True)`` on the compressed
        model) gives each calibrated leaf a static act scale as a
        ``<leaf>_aq`` sibling; uncalibrated leaves quantize dynamically."""
        absmax = self._stat_absmax(stats)
        for path, _ in dbb_leaves(self.defs()):
            w = tree_get(self.params, path)
            if not isinstance(w, DBBWeight):
                continue  # dense (never compressed) or already quantized
            self.params = tree_set(self.params, path, quantize_dbb(w))
            aq = self._leaf_act_scales(path, absmax)
            if aq is not None:
                self.params = tree_set(self.params, path[:-1] + (path[-1] + "_aq",), aq)
        return self._absorb()

    # -------------------------------------------------------------- plan
    def _staged(self, tree, m: int, dynamic: bool = False, choice=None):
        """``tree`` with every compressed projection staged at ``m`` rows
        (:func:`~repro_torch.models.common.stage_linear`, its ``_aq``
        sibling frozen in; with ``dynamic`` an int8 projection without one
        computes its activation scale from each call's batch; ``choice``
        as ``stage_linear``'s)."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self._staged(v, m, dynamic, choice)
            elif hasattr(v, "fmt"):
                out[k] = stage_linear(v, tree.get(f"{k}_aq"), m, self.cfg.compute_dtype,
                                      dynamic=dynamic, choice=choice)
            else:
                out[k] = v
        return out

    def _staged_block(self, kind, p, m: int, choice=None):
        """One block's tree staged at ``m`` rows. The recurrent mixers'
        projections are staged dynamic: the reference calls them with no
        name, so calibration never gives them a scale, and its jitted plan
        quantizes them per batch. Every other projection needs its
        calibrated scale."""
        out = self._staged({k: v for k, v in p.items() if k != "mixer"}, m, choice=choice)
        out["mixer"] = self._staged(p["mixer"], m, dynamic=kind in ("rec", "rwkv"),
                                    choice=choice)
        return out

    def _tune_gemms(self, m: int, *, tune: str, cache=None, top_k: int = 4, reps: int = 3):
        """Resolve the measured best launch choice of every unique compressed
        product (m, k, n, fmt, dtype) of the model, int8 for a quantized
        weight and the compute dtype otherwise: one search each under
        ``'search'`` (``autotune.tiles_for_matmul``), which installs it in
        the tuned registry the staged projections and every later launch
        read. Nothing on the CPU."""
        from repro_torch.kernels import autotune
        from repro_torch.models.plan import resolve_tune_cache

        cache = resolve_tune_cache(tune, cache, self.device)
        seen = set()
        for path, pdef in dbb_leaves(self.defs()):
            w = tree_get(self.params, path)
            if not hasattr(w, "fmt"):
                continue  # never compressed (the MoE's expert stacks)
            k, n = pdef.shape[-2:]
            dtype = torch.int8 if isinstance(w, QuantDBBWeight) else self.cfg.compute_dtype
            sig = (m, k, n, w.fmt, dtype)
            if sig in seen:
                continue
            seen.add(sig)
            autotune.tiles_for_matmul(m, k, n, w.fmt, dtype, mode=tune, cache=cache,
                                      top_k=top_k, reps=reps, device=self.device)

    def plan(self, *, batch: int, seq: int, tune: str = "cache", cache=None, top_k: int = 4,
             reps: int = 3):
        """Freeze a serving plan of prefill at (``batch``, ``seq``): the
        stages ``embed``, ``g{g}.b{i}`` for every block of every group,
        ``t{i}`` for the tail, ``head`` (final norm and logits), each with
        its tensors frozen in and every compressed projection staged (the
        index row, the scale products with the calibrated act scales, each
        group's sliced on the card now, the flush rows and the tile plan;
        a recurrent mixer's projections with a scale row that each call
        fills on the card from its batch).
        The sample is one row of int32 tokens. On a card the chain is
        captured into one CUDA graph per input signature at its first
        ``serve``. The projections' launch choices are resolved up front, as
        the reference's (``_tune_gemms`` under ``'cache'`` or ``'search'``,
        into the tuned registry), and frozen into the staged projections at
        the build; ``'off'`` stages the rules' choices.
        A frontend or cross-attention raises ``NotImplementedError``
        (:func:`check_plannable`), as the reference's."""
        from repro_torch.models.plan import PlanBuilder

        c = self.cfg
        check_plannable(c)
        params = self.params
        dev = self.device
        m = batch * seq
        pb = PlanBuilder(c.name, params, batch=batch, tune=tune, cache=cache, top_k=top_k,
                         reps=reps, sample_spec=((seq,), "int32"), device=dev)
        if tune != "off":
            self._tune_gemms(m, **pb.tune_kw)
        choice = {} if tune == "off" else None  # {}: the rules; None: the registry
        positions = torch.arange(seq, device=dev).expand(batch, seq)
        pb.raw("embed", "embed", self._embed)

        def block(kind, p):
            return lambda x: self._apply_block(kind, p, x, positions)[0]

        def staged(kind, p):
            return block(kind, self._staged_block(kind, p, m, choice))

        for g in range(c.num_groups):
            gp = tree_slice(params["layers"], g)
            for i, kind in enumerate(c.pattern):
                pb.raw(f"g{g}.b{i}", kind, staged(kind, gp[f"b{i}"]))
        for i, kind in enumerate(c.tail_pattern):
            pb.raw(f"t{i}", kind, staged(kind, params["tail"][f"t{i}"]))
        final_norm = params["final_norm"]
        pb.raw("head", "head", lambda x: self._logits(self._apply_norm(final_norm, x)))
        return pb.build()


def _stack(trees: list) -> dict:
    """Dicts of tensors with the same keys, one per group -> one dict of
    tensors stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
