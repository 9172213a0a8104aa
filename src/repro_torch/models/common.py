"""Functional plumbing shared by the LM (port of ``repro/models/common.py``).

Parameters are plain trees (nested dicts of tensors and compressed
weights). Every module describes them once by a ``defs()`` tree of
:class:`Param` leaves, from which come the initialised tensors, the
``meta`` stand-ins (:func:`abstract_params`) and the partition specs
(:func:`param_pspecs`): one source of truth for shapes and sharding.

Logical axes used across the zoo:
  'batch'   -- data parallel (mesh: ('pod',) 'data')
  'seq'     -- sequence parallel (mesh: 'model')
  'embed'   -- residual/feature dim
  'heads'   -- attention heads (mesh: 'model' when divisible)
  'kv'      -- kv heads
  'mlp'     -- FFN hidden (mesh: 'model')
  'experts' -- MoE experts (mesh: 'model')
  'vocab'   -- embedding rows / logits (mesh: 'model')
  None      -- replicated

A partition spec is a tuple of mesh axis names (or tuples of them, or
None), one entry per tensor dim, as ``jax.sharding.PartitionSpec``;
:func:`spec_placements` turns it into DTensor placements on a
``DeviceMesh``. Under :func:`sharding_rules` with a mesh the model runs on
DTensors: :func:`shard` redistributes an activation to its logical axes'
placements (the reference's ``with_sharding_constraint``), the embedding
lookup stays vocab-sharded (a masked local lookup under ``local_map`` and a
sum across the vocab shards, the reference's ``shard_map``), and a
compressed projection runs the kernel on each rank's local shard under
``local_map``. Plain tensors that meet DTensors (positions, masks, RoPE
angles, a decode step's position) are taken as replicated: the context
runs under ``implicit_replication``. Without rules, or on plain tensors,
all of this is a no-op.

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

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def abstract_params(defs, default_dtype) -> dict:
    """The defs tree as ``meta`` tensors of each leaf's shape and dtype
    (nothing allocated), the reference's ``ShapeDtypeStruct`` tree."""
    out: dict = {}
    for path, p in param_leaves(defs):
        out = tree_set(out, path, torch.empty(p.shape, dtype=p.dtype or default_dtype,
                                              device="meta"))
    return out


def param_pspecs(defs, rules: dict) -> dict:
    """The partition spec of every leaf (a tuple, one entry per dim) from
    its logical axes through ``rules`` (logical axis -> mesh axis)."""
    out: dict = {}
    for path, p in param_leaves(defs):
        out = tree_set(out, path, tuple(rules.get(a) for a in p.axes))
    return out


def constrain_shards_(w: DTensor, fmt: DBBFormat) -> None:
    """Project DTensor ``w`` (..., K, N) onto the DBB bound in place, each
    rank on its shard. A block's score sums |w| over its group of columns.
    Where the shard holds whole groups it is masked as on one device
    (``dbb_mask``, the same sums). Where the mesh splits N inside a group
    (one pattern per matrix), the partial scores are summed in fp32 across
    those shards, then rounded to ``w``'s dtype as the one-device sum is,
    so every rank picks the same pattern. Shards of K hold whole blocks."""
    from repro_torch.core.vdbb import dbb_mask, mask_from_scores

    mesh, nd = w.device_mesh, w.dim()
    n = w.shape[-1]
    g = fmt.group_size(n)
    wl = w.to_local()
    k_l, n_l = wl.shape[-2:]
    if k_l % fmt.bz:
        raise ValueError(f"a shard of {k_l} rows does not hold whole blocks of {fmt.bz}")
    slices = wl.view(-1, k_l, n_l)
    if n_l % g == 0:  # whole groups on this shard
        for sl in slices:
            sl.masked_fill_(~dbb_mask(sl, fmt), 0)
        return
    if g != n:
        raise ValueError(f"groups of {g} columns split by shards of {n_l}")
    scores = wl.abs().float().reshape(*wl.shape[:-2], k_l // fmt.bz, fmt.bz, 1, n_l).sum(-1)
    pl = [Partial() if p == Shard(nd - 1) else p for p in w.placements]
    scores = DTensor.from_local(scores, mesh, pl, run_check=False).redistribute(
        mesh, [Replicate() if p.is_partial() else p for p in pl]).to_local()
    scores = scores.to(w.dtype).reshape(-1, *scores.shape[-3:])
    for sl, sc in zip(slices, scores):  # the group's pattern over this shard's columns
        sl.masked_fill_(~mask_from_scores(sc, fmt, 1).expand(k_l, n_l), 0)


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


def tree_unstack(tree, n: int) -> list:
    """A tree stacked over ``n`` layer groups as ``n`` trees: each tensor
    unbound along its leading axis (views; under autograd one gradient
    buffer a leaf, where ``n`` indexings would each add a full-size zero
    buffer), a compressed weight indexed."""
    if isinstance(tree, dict):
        per = {k: tree_unstack(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in per.items()} for g in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [tree[g] for g in range(n)]


# ---------------------------------------------------------------------------
# Sharding: specs, placements and the rules context
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def sharding_rules(rules: Optional[dict], mesh=None):
    """Install logical -> mesh axis rules so that :func:`shard` redistributes.
    With no rules (one device) ``shard`` is a no-op. With a ``mesh`` the
    body also runs under ``implicit_replication``: a plain tensor that meets
    a DTensor counts as replicated (it must then be the same on every
    rank, as positions and masks are)."""
    prev = getattr(_CTX, "rules", None), getattr(_CTX, "mesh", None)
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _CTX.rules, _CTX.mesh = prev


def current_mesh():
    return getattr(_CTX, "mesh", None)


def current_rules() -> Optional[dict]:
    return getattr(_CTX, "rules", None)


def spec_placements(spec, mesh, shape=None, *, uneven: str = "raise") -> tuple:
    """DTensor placements of partition ``spec`` on ``mesh``: a mesh dim
    named in entry ``i`` is ``Shard(i)``, every other ``Replicate()``. An
    entry naming several mesh dims shards over them major to minor, which
    DTensor does in mesh order, so they must come in the mesh's order (pod,
    data, model). A mesh dim of one rank stays ``Replicate()``: its one
    shard is the whole, and DTensor's view rules would refuse to fold a dim
    sharded even one way. With ``shape``, a dim that the entry's mesh size
    does not divide raises, where DTensor would shard it unevenly without a
    word; ``uneven='replicate'`` leaves such a dim replicated instead."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    if shape is not None and len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the tensor's {len(shape)} dims")
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec}: mesh axes {missing} are not in the mesh {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: entry {entry} must name mesh axes in the mesh's "
                             f"order {names}")
        if shape is not None:
            size = math.prod(mesh.size(j) for j in dims)
            if shape[i] % size:
                if uneven == "replicate":
                    continue
                raise ValueError(f"spec {spec}: dim {i} of {tuple(shape)} does not divide "
                                 f"into {size} shards over {axes}")
        for j in dims:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[j]!r} shards two dims")
            if mesh.size(j) > 1:
                out[j] = Shard(i)
    return tuple(out)


def distribute(x: torch.Tensor, mesh, spec, *, local: bool = False) -> DTensor:
    """``x``, the same full tensor on every rank, as a DTensor of ``spec``
    on ``mesh``: each rank keeps its own shard, nothing is sent. With
    ``local``, ``x`` is already this rank's shard and is wrapped as it is
    (``DTensor.from_local``: no copy)."""
    from torch.distributed.tensor import distribute_tensor

    if local:
        return DTensor.from_local(x, mesh, spec_placements(spec, mesh), run_check=False)
    return distribute_tensor(x, mesh, spec_placements(spec, mesh, x.shape), src_data_rank=None)


def distribute_tree(tree, specs, mesh, *, local: bool = False):
    """Every leaf of ``tree`` distributed by the spec at the same place in
    ``specs`` (a compressed leaf's values and indices by its
    :class:`DBBWeight` of specs, :meth:`LM.compressed_pspecs`); ``local``
    as :func:`distribute`'s."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh, local=local) for k, v in tree.items()}
    if isinstance(tree, DBBWeight):
        return dataclasses.replace(
            tree, values=distribute(tree.values, mesh, specs.values, local=local),
            indices=distribute(tree.indices, mesh, specs.indices, local=local))
    return distribute(tree, mesh, specs, local=local)


def named_shardings(specs, mesh):
    """A spec tree (:meth:`LM.pspecs`, :meth:`LM.cache_pspecs`, a
    compressed leaf's :class:`DBBWeight` of specs) as a tree of
    ``checkpoint.store.Sharding`` on ``mesh``, for
    ``store.restore(shardings=)``."""
    from repro_torch.checkpoint.store import Sharding

    if isinstance(specs, dict):
        return {k: named_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, DBBWeight):
        return dataclasses.replace(specs, values=Sharding(mesh, specs.values),
                                   indices=Sharding(mesh, specs.indices))
    return Sharding(mesh, specs)


def shard(x, axes: tuple):
    """``x`` redistributed to the placements its logical ``axes`` take under
    the installed rules (the reference's ``with_sharding_constraint``): a
    no-op with no rules installed or on a plain tensor. Partial sums become
    reduce-scatters or all-reduces here. A dim that its mesh axes do not
    divide (a decode step's one kv head over four model ranks) stays
    replicated."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = spec_placements(tuple(rules.get(a) for a in axes), mesh, x.shape,
                           uneven="replicate")
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def write_slot_(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[:, slot] = new`` along dim 1 (a cache's sequence), in place.
    On a DTensor cache every rank writes its own shard, ``new`` taken to the
    cache's placements first; on a cache split along its sequence the rank
    whose slice holds ``slot`` writes it and every other rank writes back
    what it holds (a masked write: nothing reads the slot on the host)."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, slot, new.to(buf.dtype))
        return
    mesh = buf.device_mesh
    seq = [j for j, pl in enumerate(buf.placements) if pl == Shard(1)]
    want = tuple(Replicate() if j in seq else pl for j, pl in enumerate(buf.placements))
    new = _replicated(new, mesh).redistribute(mesh, want).to_local()
    slot = slot.to_local() if isinstance(slot, DTensor) else slot
    local = buf.to_local()
    if not seq:
        local.index_copy_(1, slot, new.to(buf.dtype))
        return
    sl = local.shape[1]
    at = slot.to(local.device) - sum(mesh.get_local_rank(j) * sl for j in seq)
    inside = ((at >= 0) & (at < sl)).reshape((1, -1) + (1,) * (local.dim() - 2))
    at = at.clamp(0, sl - 1)
    local.index_copy_(1, at, torch.where(inside, new.to(buf.dtype), local.index_select(1, at)))


def _replicated(x, mesh) -> DTensor:
    return x if isinstance(x, DTensor) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False)


# ---------------------------------------------------------------------------
# Embedding lookup
# ---------------------------------------------------------------------------


def sharded_embed_lookup(table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The embedding rows of ``ids`` in ``compute_dtype``.

    On one device a plain ``index_select``. On a vocab-sharded DTensor table
    a lookup on the table's DTensor ops would all-gather the whole table
    (and all-reduce its whole gradient). This one does the reference's
    masked local lookup on each vocab shard under ``local_map``, the ids
    split over the batch axes, and returns the (B, S, d) rows in the
    compute dtype as a ``Partial`` sum over the vocab shards, which the next
    :func:`shard` reduces; the table and its gradient never leave their
    shards along the vocab axis. (Where the rules also shard the table's
    feature dim, as training's FSDP does over 'data', that dim is gathered
    as the reference's ``shard_map`` in_specs gather it.)"""
    rules = current_rules()
    axis = rules.get("vocab") if rules else None
    if not isinstance(table, DTensor) or axis is None:
        rows = table.index_select(0, ids.reshape(-1))
        return rows.reshape(*ids.shape, table.shape[-1]).to(compute_dtype)
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    vdim = names.index(axis)
    nd = ids.dim()
    tbl_pl = spec_placements((axis, None), mesh, table.shape)
    ids_pl = spec_placements((rules.get("batch"),) + (None,) * (nd - 1), mesh, ids.shape)
    out_pl = tuple(Partial() if j == vdim else p for j, p in enumerate(ids_pl))
    # each batch shard's lookups give part of the table's gradient
    grad_pl = tuple(Partial() if isinstance(ip, Shard) else tp for ip, tp in zip(ids_pl, tbl_pl))

    def local(tbl, ids_l):
        v_loc = tbl.shape[0]
        loc = ids_l.long() - mesh.get_local_rank(vdim) * v_loc
        ok = (loc >= 0) & (loc < v_loc)
        rows = tbl.index_select(0, loc.clamp(0, v_loc - 1).reshape(-1))
        rows = rows.reshape(*ids_l.shape, tbl.shape[-1]).to(compute_dtype)
        return torch.where(ok[..., None], rows, torch.zeros((), dtype=compute_dtype,
                                                            device=rows.device))

    fn = local_map(local, out_placements=(out_pl,), in_placements=(tbl_pl, ids_pl),
                   in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, _replicated(ids, mesh))


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
    cast at use, as the reference does. A weight on DTensors runs the
    kernel on each rank's shard (:func:`_sharded_linear`)."""
    from repro_torch.kernels import ops

    _shared_pattern(w)
    if isinstance(w.values, DTensor):
        return _sharded_linear(x, w)
    k, n = w.shape
    if w.values.dtype != x.dtype:
        w = dataclasses.replace(w, values=w.values.to(x.dtype))
    y = ops.vdbb_matmul(_rows(x, k), w)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


def _sharded_linear(x, w: DBBWeight):
    """:func:`_compressed_linear` on every rank's shard under ``local_map``, the
    weight's compressed values and indices as the mesh holds them; the
    ctypes kernels take raw pointers, so they see local tensors only.

    Per mesh dim, by the placement of the values (nb, nnz, N):
      - ``Shard(2)``, N split (column-parallel): the input is replicated
        there and each rank computes its own columns, no collective;
      - ``Shard(0)``, the blocks of K split (row-parallel, ``wo``,
        ``w_down``): the input is split along its last dim to match, each
        rank contracts its block range, and the output is ``Partial``;
      - replicated: the input keeps its split of a leading (batch) dim, or
        its pending sum, and the output takes the same placement.
    The local K must be a whole number of blocks. Nothing is densified."""
    from torch.distributed.tensor.experimental import local_map

    if w.values.dim() != 3:
        raise ValueError("a stacked compressed weight is indexed by layer group before use")
    mesh = w.values.device_mesh
    x = _replicated(x, mesh)
    last = x.dim() - 1
    # the gradients' placements too: a column shard gives part of the input's
    # gradient, a batch shard part of the weight's
    x_pl, out_pl, x_grad, v_grad = [], [], [], []
    for vp, xp in zip(w.values.placements, x.placements):
        if vp == Shard(0):
            x_pl.append(Shard(last))
            out_pl.append(Partial())
            x_grad.append(Shard(last))
            v_grad.append(vp)
        elif vp == Shard(2):
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
            x_grad.append(Partial())
            v_grad.append(vp)
        elif isinstance(vp, Replicate):
            keep = xp.is_partial() or (isinstance(xp, Shard) and xp.dim != last)
            x_pl.append(xp if keep else Replicate())
            out_pl.append(x_pl[-1])
            x_grad.append(x_pl[-1])
            v_grad.append(Partial() if keep else vp)
        else:
            raise ValueError(f"compressed values placed {tuple(w.values.placements)}: a mesh "
                             "dim may split the blocks (dim 0) or the columns (dim 2)")
    fmt = w.fmt

    def local(xl, vl, il):
        k = xl.shape[-1]
        if k % fmt.bz or k != vl.shape[0] * fmt.bz:
            raise ValueError(f"local K {k} is not the shard's {vl.shape[0]} blocks of {fmt.bz}")
        return _compressed_linear(xl, DBBWeight(vl, il, fmt, (k, vl.shape[-1])))

    idx_pl = tuple(w.indices.placements)
    fn = local_map(local, out_placements=(tuple(out_pl),),
                   in_placements=(tuple(x_pl), tuple(w.values.placements), idx_pl),
                   in_grad_placements=(tuple(x_grad), tuple(v_grad), idx_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, w.values, w.indices)


def _dense_sharded_linear(x, w: DTensor):
    """``x @ w`` for a dense weight on DTensors, each rank's product on its
    own shards under ``local_map``, the layout chosen per mesh dim by the
    weight's placement (rather than by DTensor's strategy search, which on
    a 3-D mesh plans every candidate's redistribution and costs seconds an
    op):
      - ``Shard(1)``, N split (column-parallel): the input gathered there,
        the output split along its last dim;
      - ``Shard(0)``, K split: where the input is split along a leading
        (batch) dim on the same mesh dim, the weight is gathered for the
        product (training's FSDP over 'data'), its gradient a partial sum
        that the gather's backward reduce-scatters; otherwise
        row-parallel, the input split along its last dim to match and the
        output ``Partial``;
      - replicated: the input keeps a split of a leading dim, else it is
        gathered (a pending sum reduced first)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    x = _replicated(x, mesh)
    last = x.dim() - 1
    w_in, x_in, out_pl, x_grad, w_grad = [], [], [], [], []
    for wp, xp in zip(w.placements, x.placements):
        lead = isinstance(xp, Shard) and xp.dim != last
        if wp == Shard(1):
            layout = (wp, Replicate(), Shard(last), Partial(), wp)
        elif wp == Shard(0) and lead:
            layout = (Replicate(), xp, xp, xp, Partial())
        elif wp == Shard(0):
            layout = (wp, Shard(last), Partial(), Shard(last), wp)
        elif isinstance(wp, Replicate):
            keep = xp if lead else Replicate()
            layout = (wp, keep, keep, keep, Partial() if lead else wp)
        else:
            raise ValueError(f"a dense weight placed {tuple(w.placements)}: a mesh dim may split "
                             "K (dim 0) or N (dim 1)")
        for acc, pl in zip((w_in, x_in, out_pl, x_grad, w_grad), layout):
            acc.append(pl)

    def local(xl, wl):
        return xl @ wl.to(xl.dtype)

    fn = local_map(local, out_placements=(tuple(out_pl),),
                   in_placements=(tuple(x_in), tuple(w_in)),
                   in_grad_placements=(tuple(x_grad), tuple(w_grad)), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(x, w)


def _quant_linear(x: torch.Tensor, qw: QuantDBBWeight, aq) -> torch.Tensor:
    """INT8 matmul for a quantized compressed weight -> fp32. ``aq`` is the
    calibrated per-tensor activation scale (None: dynamic); an int8 ``x``
    is the previous layer's codes and needs ``aq``."""
    from repro_torch.kernels import ops

    _shared_pattern(qw)
    if isinstance(qw.values, DTensor):
        raise NotImplementedError("an int8 projection on a mesh: the sharded serve path runs "
                                  "floating compressed weights")
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
    elif isinstance(w, DTensor):
        y = _dense_sharded_linear(x, w)
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
