"""Functional plumbing shared by the LM (port of ``repro/models/common.py``).

Parameters are plain trees (nested dicts of tensors and compressed
weights). Every module describes them once by a ``defs()`` tree of
:class:`Param` leaves, from which the initialised tensors come. The logical
axes are kept as the reference names them. The reference's sharding
annotations have no counterpart: the port runs on one card (mesh work is
ROADMAP queue 1, item 14).

:func:`apply_linear` is the LM's one on-ramp to the VDBB datapath: a
compressed :class:`DBBWeight` with one pattern per matrix runs
``ops.vdbb_matmul`` (the tc kernel: its bf16 or fp32 instantiation), an
int8 :class:`QuantDBBWeight` ``ops.quant_matmul`` (the tc kernel on the int8
tensor cores), each at any M (the TPU's tiny-M rule is dropped on CUDA), and
a dense weight ``x @ w``. Casts follow the reference exactly: norms compute
in fp32, cast to the activation dtype, then scale by ``gamma`` in it; RoPE
computes its angles in fp32; a quantized fp32 output is cast back to a
floating input's dtype, and the bias is added after the product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core import act_sparsity
from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBFormat, DBBWeight, dbb_prune


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'scaled'
    scale: float = 1.0
    dtype: Any = None  # defaults to the model's param dtype
    # DBB sparsity: set for weights the paper's technique applies to
    dbb: Optional[DBBFormat] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def param_leaves(defs, prefix=()):
    """(path, Param) for every leaf of a defs tree, dict keys sorted (the
    reference's flatten order)."""
    if isinstance(defs, Param):
        yield prefix, defs
        return
    for k in sorted(defs):
        yield from param_leaves(defs[k], prefix + (k,))


def _init_leaf(p: Param, generator: torch.Generator, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if len(p.shape) >= 4:
        # a stack of stacks (the MoE's (L, E, d, f) experts): drawn one
        # leading slice at a time into the leaf's dtype, so the fp32
        # temporary is one slice (a whole full-width stack would be 35 GB)
        sub = dataclasses.replace(p, shape=p.shape[1:], axes=p.axes[1:])
        w = torch.empty(p.shape, dtype=dtype, device=device)
        for i in range(p.shape[0]):
            w[i] = _init_leaf(sub, generator, dtype, device)
        return w
    w = torch.empty(p.shape, dtype=torch.float32, device=device)
    if p.init == "scaled":  # fan-in scaled truncated normal
        # fan-in is the contraction dim: second-to-last, so stacked
        # layer-group weights (G, K, N) scale by K, not by G
        fan_in = p.shape[-2] if len(p.shape) >= 2 else max(p.shape[0], 1)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(p.scale / math.sqrt(fan_in))
    else:
        w.normal_(generator=generator).mul_(p.scale)
    return w.to(dtype=dtype)


def init_params(defs, generator: torch.Generator, default_dtype, device,
                leaf_fn: Optional[Callable] = None) -> dict:
    """Initialise a defs tree from ``generator``, drawn in fp32 on
    ``device`` (the generator's device: torch refuses a mismatch) and cast
    to each leaf's dtype there. DBB-tagged 2-D leaves
    are magnitude-pruned, as in the reference. ``leaf_fn(path, param,
    tensor)`` (optional) maps each leaf as soon as it is drawn, so that a
    compressed model never holds its whole dense tree."""
    device = torch.device(device)
    out: dict = {}
    for path, p in param_leaves(defs):
        w = _init_leaf(p, generator, p.dtype or default_dtype, device)
        if p.dbb is not None and not p.dbb.is_dense and w.dim() == 2:
            w = dbb_prune(w, p.dbb)
        if leaf_fn is not None:
            w = leaf_fn(path, p, w)
        out = tree_set(out, path, w)
    return out


def dbb_leaves(defs, prefix=()):
    """Yield (path, Param) for every DBB-tagged weight."""
    for path, p in param_leaves(defs, prefix):
        if p.dbb is not None:
            yield path, p


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree, path, val):
    """Functionally set (or insert, e.g. the ``<leaf>_aq`` calibration
    siblings ``LM.quantize`` adds) a leaf at ``path``."""
    if not path:
        return val
    out = dict(tree)
    out[path[0]] = tree_set(tree.get(path[0], {}), path[1:], val)
    return out


def tree_slice(tree, g: int):
    """Group ``g`` of a tree stacked over layer groups: every tensor's and
    every compressed weight's leading axis indexed (views, no copy)."""
    if isinstance(tree, dict):
        return {k: tree_slice(v, g) for k, v in tree.items()}
    return tree[g]


# ---------------------------------------------------------------------------
# Embedding lookup (the reference's sharded lookup, on one card)
# ---------------------------------------------------------------------------


def sharded_embed_lookup(table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The embedding rows of ``ids`` in ``compute_dtype`` (a plain
    ``index_select`` on one card)."""
    rows = table.index_select(0, ids.reshape(-1))
    return rows.reshape(*ids.shape, table.shape[-1]).to(compute_dtype)


# ---------------------------------------------------------------------------
# Math helpers
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def layer_norm(x, gamma, beta, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt) + beta.to(dt)


def rope(x, positions, theta=10000.0):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S). Angles and
    the rotation in fp32, the result in ``x``'s dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., :, None, None].float() * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear layers on the VDBB datapath
# ---------------------------------------------------------------------------


def _shared_pattern(w) -> None:
    k, n = w.shape
    if w.fmt.group_size(n) != n:
        raise NotImplementedError(
            f"a per-column VDBB weight (group={w.fmt.group!r}) in an LM projection: the LM "
            "configs make one pattern per matrix ('matrix'); the bw kernels serve the CNN")


@dataclasses.dataclass(frozen=True)
class StagedLinear:
    """A compressed projection staged once for a frozen plan
    (``models/plan.py``): the kernel's weight side (the shared index row,
    the dequant scale product with the calibrated activation scale, the
    flush rows and the tile plan) resolved, ``run(x2)`` the product of an
    (M, K) input. ``quantized`` says whether it is the int8 datapath."""

    run: Callable
    shape: tuple
    fmt: DBBFormat
    quantized: bool


def stage_linear(w, aq, m: int, compute_dtype, *, dynamic: bool = False,
                 choice=None) -> StagedLinear:
    """Stage :func:`apply_linear`'s product with a compressed ``w`` at ``m``
    rows: ``ops.stage_quant_matmul`` for an int8 weight (which needs its
    calibrated ``aq``, unless ``dynamic`` lets it quantize each call's batch
    at its own scale when it has none), ``ops.stage_vdbb_matmul`` for a
    floating one, its values in ``compute_dtype`` as the unplanned path
    casts them. The launch choice is frozen at the stage: ``choice``, else
    the tuned registry's (``None``), ``{}`` the rule's."""
    from repro_torch.kernels import ops

    _shared_pattern(w)
    if isinstance(w, QuantDBBWeight):
        run, _ = ops.stage_quant_matmul(w, aq, m, dynamic=dynamic, choice=choice)
        return StagedLinear(run, w.shape, w.fmt, True)
    if w.values.dtype != compute_dtype:
        w = dataclasses.replace(w, values=w.values.to(compute_dtype))
    run, _ = ops.stage_vdbb_matmul(w, m, choice=choice)
    return StagedLinear(run, w.shape, w.fmt, False)


def is_quantized(w) -> bool:
    """An int8 projection, staged or not."""
    return isinstance(w, QuantDBBWeight) or (isinstance(w, StagedLinear) and w.quantized)


def _rows(x, k):
    m = x.numel() // max(k, 1)
    return x.reshape(m, k).contiguous()


def _compressed_linear(x: torch.Tensor, w: DBBWeight) -> torch.Tensor:
    """Compressed matmul for a floating DBBWeight, never densified: the tc
    kernel over the compressed K. Values of another dtype than ``x`` are
    cast at use, as the reference does."""
    from repro_torch.kernels import ops

    _shared_pattern(w)
    k, n = w.shape
    if w.values.dtype != x.dtype:
        w = dataclasses.replace(w, values=w.values.to(x.dtype))
    y = ops.vdbb_matmul(_rows(x, k), w)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


def _quant_linear(x: torch.Tensor, qw: QuantDBBWeight, aq) -> torch.Tensor:
    """INT8 matmul for a quantized compressed weight -> fp32. ``aq`` is the
    calibrated per-tensor activation scale (None: dynamic); an int8 ``x``
    is the previous layer's codes and needs ``aq``."""
    from repro_torch.kernels import ops

    _shared_pattern(qw)
    k, n = qw.shape
    return ops.quant_matmul(_rows(x, k), qw, aq).reshape(*x.shape[:-1], n)


def apply_linear(x: torch.Tensor, w, bias=None, *, aq=None, name: str = "") -> torch.Tensor:
    """``x @ w`` where ``w`` is dense, a compressed :class:`DBBWeight`, an
    int8 :class:`QuantDBBWeight` or a plan's :class:`StagedLinear`.

    While an activation collector is installed the input is recorded under
    the current ``act_scope`` as ``<scope>.<name>``, MAC-weighted by the
    GEMM's executed occupancy: the address ``LM.quantize`` looks the layer's
    calibrated scale up by. The device of ``x`` decides the path (a CPU
    tensor takes the kernel's plain version, a CUDA one the kernel), where
    the reference reads its config's ``kernel_mode``.
    """
    if act_sparsity.collecting():
        k = x.shape[-1]
        rows = x.numel() // max(k, 1)
        if isinstance(w, (DBBWeight, QuantDBBWeight, StagedLinear)):
            macs = rows * (w.shape[0] // w.fmt.bz) * w.fmt.nnz * w.shape[1]
        else:
            macs = rows * k * w.shape[-1]
        act_sparsity.record_activation(x, name=act_sparsity.scoped(name), macs=macs)
    if isinstance(w, StagedLinear):
        y = w.run(_rows(x, w.shape[0])).reshape(*x.shape[:-1], w.shape[1])
        if x.dtype.is_floating_point and y.dtype != x.dtype:
            y = y.to(x.dtype)
    elif isinstance(w, QuantDBBWeight):
        y = _quant_linear(x, w, aq)
        if x.dtype.is_floating_point and y.dtype != x.dtype:
            y = y.to(x.dtype)
    elif isinstance(w, DBBWeight):
        y = _compressed_linear(x, w)
    else:
        y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def linear_def(k, n, k_axis, n_axis, *, dbb=None, scale=1.0, dtype=None) -> Param:
    """A (k, n) projection weight; its feature axis is named 'w_embed', as
    the reference's FSDP rule wants."""
    remap = {"embed": "w_embed"}
    return Param((k, n), (remap.get(k_axis, k_axis), remap.get(n_axis, n_axis)),
                 "scaled", scale, dtype, dbb)
