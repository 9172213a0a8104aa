"""SparseCNN — sparse CNN inference on the VDBB datapath (port of
``repro/models/cnn.py``, which has the plain layout only).

One class, two layouts (:class:`CNNConfig` ``block``): a VGG-style stack of
:class:`DBBConv2d` stages (``'plain'``: stride 2 at the first conv of every
stage after the first), or ResNet v1.5 (``'bottleneck'``: a 7 × 7 stem, a
max-pool and stages of bottleneck blocks with residual adds and projection
shortcuts); then global average pooling and a :class:`DBBLinear` head. The
module's children are ``l0 … lN`` in either layout (the plain layout's are
the reference's parameter keys; a bottleneck block's convs are
consecutive, its projection last, :attr:`SparseCNN.blocks`);
:meth:`compress`, :meth:`quantize` and :meth:`constrain` convert their state
in place.

Calibrated quantized state takes the int8-resident chain: the fp32 stem is
one dense kernel whose epilogue requantizes to int8 (then, for ResNet, the
max-pool on the codes), every compressed conv one IM2COL × VDBB kernel from
int8 codes to the next layer's int8 codes (a block's last conv adds the
shortcut's codes in its epilogue, before ReLU), the last conv flushes fp32
into global average pooling, and the quantized head is one GEMM kernel. The
port has no CNN trainer; the training-time projection (:meth:`constrain`)
works on either layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core.act_sparsity import measure_activation
from repro_torch.core.quant import QuantDBBWeight, act_scale_from_stats
from repro_torch.core.sparse_conv import DBBConv2d
from repro_torch.core.sparse_linear import DBBLinear
from repro_torch.core.vdbb import DBBFormat, DENSE
from repro_torch.kernels import ops
from repro_torch.spans import span

LAYOUTS = ("plain", "bottleneck")


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Two layouts, by ``block``:

    - ``'plain'``, a VGG-style stack: ``stage_channels`` are each stage's
      output channels, ``convs_per_stage`` convs of ``kernel_size`` a stage
      (XLA's SAME padding), stage i > 0 downsamples 2× at its first conv;
      the first conv (C = ``in_channels``, not blockable) is the dense stem.
    - ``'bottleneck'``, ResNet v1.5: a dense stem conv to ``stem_channels``
      (``stem_kernel`` × ``stem_kernel`` at ``stem_stride``), an optional
      ``max_pool`` (kernel, stride, pad), then ``blocks_per_stage[i]``
      bottleneck blocks of inner width ``stage_channels[i]``: a 1 × 1 conv,
      a 3 × 3 conv carrying the block's stride (2 on the first block of
      every stage after the first: v1.5 puts it here, not on the 1 × 1), a
      1 × 1 conv to ``expansion`` × the inner width, the shortcut added,
      then ReLU. A block whose stride or width changes (each stage's first)
      has a 1 × 1 projection shortcut at its stride. Every conv pads
      k // 2 on each side, as torchvision's (XLA's SAME puts a stride-2
      conv's extra row at the end instead)."""

    name: str = "sparse-cnn"
    in_channels: int = 3
    image_size: int = 32
    stage_channels: Sequence[int] = (32, 64, 128)
    convs_per_stage: int = 2
    kernel_size: int = 3
    num_classes: int = 10
    dbb: Optional[DBBFormat] = None
    block: str = "plain"
    stem_channels: int = 64
    stem_kernel: int = 7
    stem_stride: int = 2
    max_pool: Optional[Tuple[int, int, int]] = None
    blocks_per_stage: Sequence[int] = ()
    expansion: int = 4

    @property
    def fmt(self) -> DBBFormat:
        return self.dbb or DENSE

    def param_count(self) -> int:
        total = 0
        for m in SparseCNN(self).layers():
            if isinstance(m, DBBConv2d):
                total += m.kh * m.kw * m.in_channels * m.out_channels
            else:
                total += m.in_features * m.out_features
        return total


@dataclasses.dataclass(frozen=True)
class Block:
    """One bottleneck block: its stage (1-based), its index in the stage,
    and the layer indices of its convs (``proj`` None: an identity
    shortcut)."""

    stage: int
    index: int
    c1: int
    c2: int
    c3: int
    proj: Optional[int]

    @property
    def name(self) -> str:
        return f"block{self.stage}.{self.index}"


def _plain_layers(c: CNNConfig) -> list:
    mods = []
    prev = c.in_channels
    for si, ch in enumerate(c.stage_channels):
        for li in range(c.convs_per_stage):
            stride = 2 if (si > 0 and li == 0) else 1
            # the C=3 stem is not bz-blockable and stays dense
            fmt = c.fmt if prev % c.fmt.bz == 0 else DENSE
            mods.append(DBBConv2d(prev, ch, kernel_size=c.kernel_size, stride=stride,
                                  padding="SAME", fmt=fmt, use_bias=True))
            prev = ch
    return mods


def _bottleneck_layers(c: CNNConfig) -> tuple:
    """(convs, blocks) of the ResNet v1.5 layout: the stem, then each
    block's 1 × 1, 3 × 3 and 1 × 1 convs and its projection, if any."""
    if len(c.blocks_per_stage) != len(c.stage_channels):
        raise ValueError(f"{c.name}: {len(c.blocks_per_stage)} block counts for "
                         f"{len(c.stage_channels)} stages")

    def conv(cin, cout, k, stride):
        fmt = c.fmt if cin % c.fmt.bz == 0 else DENSE  # the C = 3 stem stays dense
        p = (k // 2, k // 2)
        return DBBConv2d(cin, cout, kernel_size=k, stride=stride, padding=(p, p), fmt=fmt,
                         use_bias=True)

    mods = [conv(c.in_channels, c.stem_channels, c.stem_kernel, c.stem_stride)]
    blocks, prev = [], c.stem_channels
    for si, (inner, n) in enumerate(zip(c.stage_channels, c.blocks_per_stage)):
        out = inner * c.expansion
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            i = len(mods)
            mods += [conv(prev, inner, 1, 1), conv(inner, inner, 3, stride),
                     conv(inner, out, 1, 1)]
            proj = None
            if stride != 1 or prev != out:
                proj = len(mods)
                mods.append(conv(prev, out, 1, stride))
            blocks.append(Block(si + 1, bi, i, i + 1, i + 2, proj))
            prev = out
    return mods, tuple(blocks)


class SparseCNN(nn.Module):
    def __init__(self, cfg: CNNConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        if c.block not in LAYOUTS:
            raise ValueError(f"{c.name}: block {c.block!r}, expected one of {LAYOUTS}")
        self.blocks: Tuple[Block, ...] = ()
        if c.block == "bottleneck":
            mods, self.blocks = _bottleneck_layers(c)
        else:
            mods = _plain_layers(c)
        prev = mods[-1].out_channels if not self.blocks else (
            c.stage_channels[-1] * c.expansion)
        mods.append(DBBLinear(prev, c.num_classes, fmt=c.fmt, use_bias=True))
        for i, m in enumerate(mods):
            self.add_module(f"l{i}", m)
        self.n_layers = len(mods)

    def layers(self) -> list:
        """Ordered (conv …, linear head) layer modules."""
        return [getattr(self, f"l{i}") for i in range(self.n_layers)]

    def _projections(self) -> list:
        return [b.proj for b in self.blocks if b.proj is not None]

    def conv_inputs(self) -> list:
        """(h, w) of the input each conv reads, in layer order."""
        c = self.cfg
        convs = self.layers()[:-1]
        h = w = c.image_size
        if not self.blocks:
            out = []
            for m in convs:
                out.append((h, w))
                h, w = m.out_hw(h, w)
            return out
        out = [None] * len(convs)
        out[0] = (h, w)
        h, w = convs[0].out_hw(h, w)
        if c.max_pool:
            h, w = maxpool_hw(h, w, c.max_pool)
        for b in self.blocks:
            out[b.c1] = (h, w)
            if b.proj is not None:
                out[b.proj] = (h, w)
            out[b.c2] = convs[b.c1].out_hw(h, w)
            out[b.c3] = convs[b.c2].out_hw(*out[b.c2])
            h, w = convs[b.c3].out_hw(*out[b.c3])
        return out

    def init(self, generator: torch.Generator, device) -> "SparseCNN":
        """Seeded random weights (drawn on the CPU, placed on ``device``),
        projected onto the DBB constraint; zero biases. In place."""
        for m in self.layers():
            m.init(generator, device)
        return self

    # ------------------------------------------------------------- state
    def state(self) -> dict:
        """``{"l{i}": {"w", "b", "aq"}}``, the reference's parameter tree."""
        return {f"l{i}": m.state() for i, m in enumerate(self.layers())}

    def load_state(self, tree: dict) -> "SparseCNN":
        for i, m in enumerate(self.layers()):
            m.load_state(tree[f"l{i}"])
        return self

    # ----------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, *, plan=None, collect_act_stats: bool = False,
                intermediates: Optional[list] = None):
        """x: (N, H, W, C) fp32 -> logits (N, num_classes).

        With ``collect_act_stats`` returns ``(logits, stats)``, one
        :class:`ActStats` per layer, measured on the activation it reads.
        ``intermediates`` (a list) collects each conv's output. ``plan`` (a
        :class:`~repro_torch.models.plan.ModelPlan` or ``PlanSet`` of this
        model) serves through the frozen chain after checking that it was
        built from the model's current state
        (:class:`~repro_torch.models.plan.StalePlanError` otherwise); the
        unchecked hot path is ``plan.serve(x)``.
        """
        if plan is not None:
            if collect_act_stats or intermediates is not None:
                raise ValueError("plan serving is the frozen hot path; run without plan= "
                                 "to collect stats or intermediates")
            plan.check(self.state())
            return plan.serve(x)
        layers = self.layers()
        if not collect_act_stats and self._int8_chain_ready(layers):
            return self._apply_int8_resident(layers, x, intermediates)
        if self.blocks:
            return self._forward_blocks(layers, x, collect_act_stats, intermediates)
        stats = []
        h, w = x.shape[1], x.shape[2]
        for i, m in enumerate(layers[:-1]):
            if collect_act_stats:
                stats.append(measure_activation(x, name=f"l{i}",
                                                macs=m.flops(x.shape[0], h, w) // 2))
                h, w = m.out_hw(h, w)
            x = torch.relu(m(x))
            if intermediates is not None:
                intermediates.append(x)
        x = x.mean(dim=(1, 2))  # global average pool
        head = layers[-1]
        if collect_act_stats:
            stats.append(measure_activation(x, name=f"l{len(layers) - 1}",
                                            macs=head.flops(x.shape[0]) // 2))
        logits = head(x)
        if collect_act_stats:
            return logits, tuple(stats)
        return logits

    def _forward_blocks(self, layers, x, collect: bool, intermediates):
        """The bottleneck layout's per-layer forward (fp32, or quantized
        layers one at a time). With ``collect`` the stats are one
        :class:`ActStats` per layer, measured on the activation it reads
        (a block's first conv and its projection read the same one, so they
        share it and calibrate one scale), then one per projection,
        measured on its output (the scale its codes are requantized at)."""
        c = self.cfg
        stats, outs = [None] * len(layers), []

        def measure(i, t):
            if collect:
                m = layers[i]
                macs = (m.flops(t.shape[0], t.shape[1], t.shape[2]) if t.dim() == 4
                        else m.flops(t.shape[0])) // 2
                stats[i] = measure_activation(t, name=f"l{i}", macs=macs)

        measure(0, x)
        x = torch.relu(layers[0](x))
        if c.max_pool:
            x = ops.maxpool(x, *c.max_pool)
        for b in self.blocks:
            measure(b.c1, x)
            t = torch.relu(layers[b.c1](x))
            measure(b.c2, t)
            t = torch.relu(layers[b.c2](t))
            measure(b.c3, t)
            r = x
            if b.proj is not None:
                if collect:
                    p = layers[b.proj]
                    stats[b.proj] = dataclasses.replace(
                        stats[b.c1], name=f"l{b.proj}",
                        macs=p.flops(x.shape[0], x.shape[1], x.shape[2]) // 2)
                r = layers[b.proj](x)
                if collect:
                    outs.append(measure_activation(r, name=f"l{b.proj}.out"))
            x = torch.relu(layers[b.c3](t) + r)
            if intermediates is not None:
                intermediates.append(x)
        x = x.mean(dim=(1, 2))  # global average pool
        measure(len(layers) - 1, x)
        logits = layers[-1](x)
        return (logits, tuple(stats) + tuple(outs)) if collect else logits

    def _int8_chain_ready(self, layers) -> bool:
        """True iff every compressed conv after the (fp) stem is quantized
        with a calibrated ``aq``, every projection shortcut has its output's
        scale ``oq``, and the head is quantized."""
        any_quant = False
        for i, m in enumerate(layers[:-1]):
            if isinstance(m.w, QuantDBBWeight):
                if m.aq is None:
                    return False
                any_quant = True
            elif i > 0:
                return False
        if any(layers[p].oq is None for p in self._projections()):
            return False
        return any_quant and isinstance(layers[-1].w, QuantDBBWeight)

    def _apply_int8_resident(self, layers, x, intermediates=None):
        """One fused kernel per layer, int8 activations in between."""
        if self.blocks:
            return self._int8_blocks(layers, x, intermediates)
        convs, head = layers[:-1], layers[-1]
        n = len(convs)
        for i, m in enumerate(convs):
            out_scale = convs[i + 1].aq if i + 1 < n else None
            if isinstance(m.w, QuantDBBWeight):
                x = m.quant_serve(x, relu=True, out_scale=out_scale)
            else:
                x = m.dense_serve(x, relu=True, out_scale=out_scale)
            if intermediates is not None:
                intermediates.append(x)
        x = x.mean(dim=(1, 2))  # global average pool over the fp32 flush
        return head.quant_serve(x)

    def _block_scales(self, layers, j: int) -> tuple:
        """Block j's (output scale: the next block's input scale, None for
        the last block's fp32 flush; the shortcut's scale: the projection's
        output scale ``oq``, else the block input's, its first conv's
        ``aq``)."""
        b = self.blocks[j]
        nxt = layers[self.blocks[j + 1].c1].aq if j + 1 < len(self.blocks) else None
        res = layers[b.proj].oq if b.proj is not None else layers[b.c1].aq
        return nxt, res

    def _int8_blocks(self, layers, x, intermediates=None):
        """The int8-resident chain of the bottleneck layout: the stem's
        epilogue requantizes at the first block's input scale, the max-pool
        keeps it, each block runs from codes to codes (its projection to
        codes at ``oq``; its last conv adds the shortcut's codes in its
        flush), the last block flushes fp32 into the pooling, then the
        head."""
        c = self.cfg
        with span("cnn.stem"):
            x = layers[0].dense_serve(x, relu=True, out_scale=layers[self.blocks[0].c1].aq)
            if c.max_pool:
                x = ops.maxpool(x, *c.max_pool)
        for j, b in enumerate(self.blocks):
            out_scale, res_scale = self._block_scales(layers, j)
            with span(f"cnn.{b.name}"):
                t = layers[b.c1].quant_serve(x, relu=True, out_scale=layers[b.c2].aq)
                t = layers[b.c2].quant_serve(t, relu=True, out_scale=layers[b.c3].aq)
                r = x
                if b.proj is not None:
                    p = layers[b.proj]
                    r = p.quant_serve(x, out_scale=p.oq)
                x = layers[b.c3].quant_serve(t, relu=True, out_scale=out_scale,
                                             residual=(r, res_scale))
            if intermediates is not None:
                intermediates.append(x)
        with span("cnn.head"):
            return layers[-1].quant_serve(x.mean(dim=(1, 2)))

    # ------------------------------------------------- frozen serving plans
    def plan(self, *, batch: int, tune: str = "cache", cache=None, top_k: int = 4, reps: int = 3,
             pool=None, graphs: bool = True, choices=None):
        """Freeze a serving plan for request batch ``batch`` (port of the
        reference's ``plan``): the stages ``l0 … l{n-1}`` (each conv on the
        path :meth:`forward` takes for the current state, the fused int8
        chain when calibrated), ``gap`` and the head, each with its tensors
        frozen in. Every layer's launch choice is resolved under ``tune``
        (the tuned registry → the autotune ``cache`` → a search when
        ``'search'``; ``'cache'`` never searches, ``'off'`` keeps the rules;
        on the CPU the rules) and frozen into its stage, as the reference
        pins its tiles. On a card the chain is captured into a CUDA graph at
        its first ``serve`` of a signature, from ``pool`` (a
        :class:`~repro_torch.models.plan.GraphPool`; :meth:`plan_set` shares
        one across its buckets). ``graphs=False`` stages the same chain to
        run eagerly on a card, each kernel launched by its wrapper
        (:meth:`fallback_plan_set`). ``choices`` ({stage: choice},
        ``plan.frozen_choices`` of another plan) freezes each named stage to
        that launch choice instead of resolving one."""
        from repro_torch.models.plan import PlanBuilder

        layers = self.layers()
        convs, head = layers[:-1], layers[-1]
        fused = self._int8_chain_ready(layers)
        c = self.cfg
        h = w = c.image_size
        n = len(convs)
        pb = PlanBuilder(c.name, self.state(), batch=batch, tune=tune, cache=cache, top_k=top_k,
                         reps=reps,
                         sample_spec=((c.image_size, c.image_size, c.in_channels), "float32"),
                         device=head.w.device, pool=pool, graphs=graphs)
        choices = choices or {}
        if self.blocks:
            self._plan_blocks(pb, layers, batch, fused, choices)
            return pb.build()
        for i, m in enumerate(convs):
            out_scale = convs[i + 1].aq if fused and i + 1 < n else None
            pb.stage(f"l{i}", "conv", m.make_plan, batch=batch, h=h, w=w, relu=True,
                     out_scale=out_scale, fused=fused, choice=choices.get(f"l{i}"))
            h, w = m.out_hw(h, w)
        pb.raw("gap", "pool", lambda x: x.mean(dim=(1, 2)))
        pb.stage(f"l{n}", "linear", head.make_plan, batch=batch, fused=fused,
                 choice=choices.get(f"l{n}"))
        return pb.build()

    def _plan_blocks(self, pb, layers, batch: int, fused: bool, choices: dict) -> None:
        """The bottleneck layout's stages: ``stem`` (the stem conv, then the
        max-pool), one stage a block (``block<stage>.<i>``: its convs' staged
        runs, the shortcut added in its last conv's flush on the fused
        chain, else by a torch add before the ReLU) and ``head`` (the
        pooling, then the head). Each stage's run opens the span
        ``cnn.<stage>`` (``repro_torch/spans.py``): the eager chain shows
        per stage in a trace; a replayed graph runs no Python. A block's
        tiles are its convs' (``{"l<i>": tiles}``), and its ``choices`` entry
        maps its convs to their launch choices the same way."""
        c = self.cfg
        h = w = c.image_size
        stem = layers[0]
        out_scale = layers[self.blocks[0].c1].aq if fused else None
        run0, tiles = stem.make_plan(batch=batch, h=h, w=w, relu=True, out_scale=out_scale,
                                     fused=fused, choice=choices.get("stem"), **pb.tune_kw)
        h, w = stem.out_hw(h, w)
        pool = c.max_pool
        if pool:
            h, w = maxpool_hw(h, w, pool)

        def stem_run(x, run0=run0):
            with span("cnn.stem"):
                x = run0(x)
                return ops.maxpool(x, *pool) if pool else x

        pb.stage("stem", "conv", _staged(stem_run, tiles))
        for j, b in enumerate(self.blocks):
            ch = choices.get(b.name) or {}
            nxt, res_scale = self._block_scales(layers, j)

            def make(i, hw, **kw):
                return layers[i].make_plan(batch=batch, h=hw[0], w=hw[1], fused=fused,
                                           choice=ch.get(f"l{i}"), **kw, **pb.tune_kw)

            hw2 = layers[b.c1].out_hw(h, w)
            hw3 = layers[b.c2].out_hw(*hw2)
            q = (lambda i: layers[i].aq if fused else None)
            r1, t1 = make(b.c1, (h, w), relu=True, out_scale=q(b.c2))
            r2, t2 = make(b.c2, hw2, relu=True, out_scale=q(b.c3))
            r3, t3 = make(b.c3, hw3, relu=fused, out_scale=nxt if fused else None,
                          res_scale=res_scale if fused else None)
            tiles = {f"l{b.c1}": t1, f"l{b.c2}": t2, f"l{b.c3}": t3}
            rp = None
            if b.proj is not None:
                p = layers[b.proj]
                rp, tiles[f"l{b.proj}"] = make(b.proj, (h, w), out_scale=p.oq if fused else None)

            def block_run(x, r1=r1, r2=r2, r3=r3, rp=rp, name=f"cnn.{b.name}"):
                with span(name):
                    t = r2(r1(x))
                    r = x if rp is None else rp(x)
                    return r3(t, r) if fused else torch.relu(r3(t) + r)

            pb.stage(b.name, "block", _staged(block_run, tiles))
            h, w = layers[b.c3].out_hw(*hw3)
        head = layers[-1]
        rh, tiles = head.make_plan(batch=batch, fused=fused, choice=choices.get("head"),
                                   **pb.tune_kw)

        def head_run(x, rh=rh):
            with span("cnn.head"):
                return rh(x.mean(dim=(1, 2)))  # global average pool, then the head

        pb.stage("head", "linear", _staged(head_run, tiles))

    def plan_set(self, *, max_batch: Optional[int] = None, buckets=None, dp: int = 1,
                 tune: str = "cache", cache=None, top_k: int = 4, reps: int = 3,
                 graphs: bool = True):
        """Freeze a bucketed serving plan set: one :meth:`plan` per
        batch-size bucket (``make_buckets(max_batch, dp=dp)`` by default),
        all pinned to the same state, resolving their launch choices against
        one parse of the autotune cache and, on a card, sharing one graph
        memory pool. ``dp`` (the data-parallel degree the set will be served
        at, ``CNNServer(mesh=)``) makes every bucket a multiple of it, so a
        padded batch splits evenly over a mesh's data axes; the set can
        restage its chain at ``b / dp`` rows on another device for those
        replicas (``plan.shard_plan_set``; a device other than the model's
        gets a copy of the state). ``serve`` takes any batch size and, once
        every bucket is warm, captures nothing new. ``tune``, ``graphs``:
        see :meth:`plan`."""
        from repro_torch.models.plan import GraphPool, build_plan_set, resolve_tune_cache

        dev = self.layers()[-1].w.device
        cache = resolve_tune_cache(tune, cache, dev)  # one parse for all buckets
        pool = GraphPool() if graphs and dev.type == "cuda" else None
        copies, pools = {dev: self}, {dev: pool}

        def restage(rows, device, choices):
            device = torch.device(device)
            if device not in copies:  # the same state on another device
                copies[device] = SparseCNN(self.cfg).load_state(_tree_to(self.state(), device))
                pools[device] = GraphPool() if graphs and device.type == "cuda" else None
            return copies[device].plan(batch=rows, tune=tune, cache=cache, top_k=top_k,
                                       reps=reps, pool=pools[device], graphs=graphs,
                                       choices=choices)

        return build_plan_set(self.cfg.name, self.state(),
                              lambda b: self.plan(batch=b, tune=tune, cache=cache, top_k=top_k,
                                                  reps=reps, pool=pool, graphs=graphs),
                              max_batch=max_batch, buckets=buckets, dp=dp, restage=restage)

    def fallback_plan_set(self, primary, *, verify: bool = True) -> dict:
        """The serving tier's per-bucket degradation closures (port of the
        reference's ``fallback_plan_set``): ``primary``'s bucket ladder
        staged again from the same state, on the same device, as the
        ``{bucket: serve}`` mapping ``CNNServer(fallback=)`` takes, verified
        bucket by bucket. The reference restages in its ``'ref'`` kernel
        mode; the port never runs a plain version on a card, so its fallback
        runs the same kernels without graphs (``plan_set(graphs=False)``):
        each wrapper launches its kernel eagerly, and a demoted bucket
        serves bit for bit what its graph serves. It rescues what fails in
        the graph path on the host (a capture or a replay that raises), not
        a kernel that refuses its inputs. On the CPU both sets run the plain
        versions, as every CPU plan does. Its launch choices are resolved
        at this build (``tune='cache'``) and frozen, as any plan's; int8
        products are exact under any tile rows."""
        from repro_torch.models.plan import fallback_closures

        eager = self.plan_set(buckets=primary.buckets, graphs=False)
        return fallback_closures(primary, eager, verify=verify)

    # ---------------------------------------------- the paper's technique
    def constrain(self, step=None, schedule=None) -> "SparseCNN":
        """In place: every dense DBB weight projected onto its constraint
        (with a ``PruneSchedule`` and a step, onto the annealed bound)."""
        for m in self.layers():
            m.constrain(step, schedule)
        return self

    def compress(self) -> "SparseCNN":
        """In place: every DBB layer's dense weight becomes compressed."""
        for m in self.layers():
            m.compress_params()
        return self

    def quantize(self, stats=None) -> "SparseCNN":
        """In place: INT8 serving state. ``stats`` (one :class:`ActStats`
        per layer, from ``forward(x, collect_act_stats=True)``) calibrates
        each layer's static activation scale; the dense stem stays fp32."""
        layers = self.layers()
        projs = self._projections()
        if stats is not None and len(stats) != len(layers) + len(projs):
            raise ValueError(
                f"calibration stats for {len(stats)} layers, model has {len(layers)}"
                + (f" and {len(projs)} projection outputs" if projs else ""))
        for i, m in enumerate(layers):
            m.quantize(act_scale_from_stats(stats[i]) if stats is not None else None)
        if stats is not None:  # each projection's codes at a scale of their own
            for p, st in zip(projs, stats[len(layers):]):
                layers[p].put("oq", torch.tensor(act_scale_from_stats(st), dtype=torch.float32,
                                                 device=layers[p].w.device))
        return self

    # ------------------------------------------------------------ costs
    def layer_costs(self, batch: int, *, bits: int = 8, act_bits=None, stats=None,
                    epilogue_fused: bool = False) -> list:
        """``(name, costs, fmt)`` for every conv layer: its
        ``vdbb.dbb_conv_costs`` dict at ``batch`` images. ``stats`` (one
        :class:`ActStats` per layer, from ``forward(x,
        collect_act_stats=True)``) records layer i's measured activation
        sparsity into its dict, ready for ``energy_model.model_workload``;
        ``bits`` / ``act_bits`` are the operand widths (8: the INT8 serving
        path) and ``epilogue_fused`` accounts the fused flush."""
        from repro_torch.core.vdbb import dbb_conv_costs

        out = []
        for i, (m, (h, w)) in enumerate(zip(self.layers(), self.conv_inputs())):
            act = stats[i] if stats is not None else None
            out.append((f"l{i}", dbb_conv_costs(
                batch, h, w, m.in_channels, m.out_channels, m.kh, m.kw, m.fmt,
                stride=m.stride, padding=m.padding, bits=bits, act_bits=act_bits, act=act,
                epilogue_fused=epilogue_fused), m.fmt))
        return out

    def flops(self, batch: int) -> int:
        """Executed MACs*2 under the time-unrolled occupancy model."""
        layers = self.layers()
        total = sum(m.flops(batch, h, w) for m, (h, w) in zip(layers, self.conv_inputs()))
        return total + layers[-1].flops(batch)


def maxpool_hw(h: int, w: int, pool) -> tuple:
    """Output (h, w) of a (kernel, stride, pad) max-pool (floor mode)."""
    k, s, p = pool
    return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1


def _staged(run, tiles):
    """A ``make_plan`` for :meth:`PlanBuilder.stage` of a run staged
    already (the tuning keywords were spent on its parts)."""
    return lambda **_: (run, tiles)


def _tree_to(tree, device):
    """A state tree with every tensor copied to ``device``."""
    from repro_torch.checkpoint.store import flatten, unflatten

    return unflatten(tree, [x.to(device) if isinstance(x, torch.Tensor) else x
                            for x in flatten(tree)[0]])
