"""SparseCNN — sparse CNN inference on the VDBB datapath (port of
``repro/models/cnn.py``).

A VGG-style stack of :class:`DBBConv2d` stages (stride 2 at the first conv
of every stage after the first), global average pooling and a
:class:`DBBLinear` head. The module's children are ``l0 … lN``, the
reference's parameter keys; :meth:`compress`, :meth:`quantize` and
:meth:`constrain` convert their state in place.

Calibrated quantized state takes the int8-resident chain: the fp32 stem is
one dense kernel whose epilogue requantizes to int8, every compressed conv
one IM2COL × VDBB kernel from int8 codes to the next layer's int8 codes, the
last conv flushes fp32 into global average pooling, and the quantized head
is one GEMM kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.core.act_sparsity import measure_activation
from repro_torch.core.quant import QuantDBBWeight, act_scale_from_stats
from repro_torch.core.sparse_conv import DBBConv2d
from repro_torch.core.sparse_linear import DBBLinear
from repro_torch.core.vdbb import DBBFormat, DENSE


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """stage_channels: output channels per stage; stage i > 0 downsamples 2×.
    convs_per_stage: conv layers per stage (the first carries the stride)."""

    name: str = "sparse-cnn"
    in_channels: int = 3
    image_size: int = 32
    stage_channels: Sequence[int] = (32, 64, 128)
    convs_per_stage: int = 2
    kernel_size: int = 3
    num_classes: int = 10
    dbb: Optional[DBBFormat] = None

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


class SparseCNN(nn.Module):
    def __init__(self, cfg: CNNConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
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
        mods.append(DBBLinear(prev, c.num_classes, fmt=c.fmt, use_bias=True))
        for i, m in enumerate(mods):
            self.add_module(f"l{i}", m)
        self.n_layers = len(mods)

    def layers(self) -> list:
        """Ordered (conv …, linear head) layer modules."""
        return [getattr(self, f"l{i}") for i in range(self.n_layers)]

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

    def _int8_chain_ready(self, layers) -> bool:
        """True iff every compressed conv after the (fp) stem is quantized
        with a calibrated ``aq`` and the head is quantized."""
        any_quant = False
        for i, m in enumerate(layers[:-1]):
            if isinstance(m.w, QuantDBBWeight):
                if m.aq is None:
                    return False
                any_quant = True
            elif i > 0:
                return False
        return any_quant and isinstance(layers[-1].w, QuantDBBWeight)

    def _apply_int8_resident(self, layers, x, intermediates=None):
        """One fused kernel per layer, int8 activations in between."""
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

    # ------------------------------------------------- frozen serving plans
    def plan(self, *, batch: int, tune: str = "cache", cache=None, top_k: int = 4, reps: int = 3,
             pool=None, graphs: bool = True):
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
        (:meth:`fallback_plan_set`)."""
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
        for i, m in enumerate(convs):
            out_scale = convs[i + 1].aq if fused and i + 1 < n else None
            pb.stage(f"l{i}", "conv", m.make_plan, batch=batch, h=h, w=w, relu=True,
                     out_scale=out_scale, fused=fused)
            h, w = m.out_hw(h, w)
        pb.raw("gap", "pool", lambda x: x.mean(dim=(1, 2)))
        pb.stage(f"l{n}", "linear", head.make_plan, batch=batch, fused=fused)
        return pb.build()

    def plan_set(self, *, max_batch: Optional[int] = None, buckets=None, tune: str = "cache",
                 cache=None, top_k: int = 4, reps: int = 3, graphs: bool = True):
        """Freeze a bucketed serving plan set: one :meth:`plan` per
        batch-size bucket (``make_buckets(max_batch)`` by default), all
        pinned to the same state, resolving their launch choices against one
        parse of the autotune cache and, on a card, sharing one graph memory
        pool. ``serve`` takes any batch size and, once every bucket is
        warm, captures nothing new. ``tune``, ``graphs``: see :meth:`plan`."""
        from repro_torch.models.plan import GraphPool, build_plan_set, resolve_tune_cache

        dev = self.layers()[-1].w.device
        cache = resolve_tune_cache(tune, cache, dev)  # one parse for all buckets
        pool = GraphPool() if graphs and dev.type == "cuda" else None
        return build_plan_set(self.cfg.name, self.state(),
                              lambda b: self.plan(batch=b, tune=tune, cache=cache, top_k=top_k,
                                                  reps=reps, pool=pool, graphs=graphs),
                              max_batch=max_batch, buckets=buckets)

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
    def constrain(self) -> "SparseCNN":
        for m in self.layers():
            m.constrain()
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
        if stats is not None and len(stats) != len(layers):
            raise ValueError(
                f"calibration stats for {len(stats)} layers, model has {len(layers)}")
        for i, m in enumerate(layers):
            m.quantize(act_scale_from_stats(stats[i]) if stats is not None else None)
        return self

    def flops(self, batch: int) -> int:
        """Executed MACs*2 under the time-unrolled occupancy model."""
        h = w = self.cfg.image_size
        total = 0
        for m in self.layers():
            if isinstance(m, DBBConv2d):
                total += m.flops(batch, h, w)
                h, w = m.out_hw(h, w)
            else:
                total += m.flops(batch)
        return total
