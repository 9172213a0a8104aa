"""AdamW with a warm-up and cosine schedule, global-norm clipping and
optional int8 error-feedback gradient compression (port of
``repro/optim/adamw.py``).

The state tree is the reference's: ``m``, ``v`` (fp32, the parameters'
structure), ``count`` (a 0-d int32), ``master`` (an fp32 copy of the
parameters when any leaf is not fp32) and ``ef`` (the error-feedback
residual, with ``grad_compression``), so a checkpoint of ``(params,
opt_state)`` restores in either package. Leaves are visited in the
reference's flatten order (``checkpoint.store.flatten``: dict keys sorted as
strings), the order the global norm's fp32 sum follows.

The update runs in place, leaf by leaf and, for a leaf stacked over layers,
slice by slice along its leading axis, each elementwise step in the
reference's order with one rounding each, so the temporaries stay one
slice wide: a literal port of the reference's ``upd`` would hold about six
fp32 copies of the largest leaf at once.

On DTensor parameters (a mesh, ``models/common.py:distribute_tree``) the
state takes each parameter's placements; a gradient is redistributed to
its parameter's placements (a pending sum reduced), and the update then
runs elementwise on every rank's local shard, in the same order of
roundings. The global norm reduces each leaf's sum of squares across the
shards that split it, so a replicated shard counts once; the error
feedback's scale is the whole leaf's maximum across its shards.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.checkpoint.store import flatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: bool = False  # int8 + error feedback


def schedule(step, cfg: OptConfig) -> float:
    """The learning rate at ``step``: linear warm-up, then a cosine decay to
    ``min_lr_frac`` of the peak, in float32 as the reference computes it.
    Returns the float32 value as a Python float."""
    f32 = np.float32
    step = f32(step)
    warm = step / f32(max(cfg.warmup_steps, 1))
    prog = np.clip((step - f32(cfg.warmup_steps)) / f32(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    # (1 - min_lr_frac) * 0.5 is a Python product in the reference, then one f32
    cos = f32(cfg.min_lr_frac) + f32((1 - cfg.min_lr_frac) * 0.5) * (
        f32(1) + np.cos(f32(math.pi) * prog))
    return float(f32(cfg.peak_lr) * (warm if step < cfg.warmup_steps else cos))


def reach(lrs, p0, cfg: OptConfig):
    """The furthest ``len(lrs)`` updates from a fresh state, at learning
    rates ``lrs``, can move a parameter that starts at ``p0`` (a number or
    an array), whatever its gradients: update ``t`` moves it by at most
    ``lr · (r_t + weight_decay · |p|)``, where ``r_t``, the largest
    ``|m̂| / sqrt(v̂)`` the moments can reach, is ``sqrt(Σ a_i² / b_i)`` over
    their bias-corrected weights (Cauchy–Schwarz; 1 at the first update)."""
    def ratio(t):
        a = [(1 - cfg.b1) * cfg.b1 ** (t - i) / (1 - cfg.b1 ** t) for i in range(1, t + 1)]
        b = [(1 - cfg.b2) * cfg.b2 ** (t - i) / (1 - cfg.b2 ** t) for i in range(1, t + 1)]
        return math.sqrt(sum(x * x / y for x, y in zip(a, b)))

    r = [ratio(t) for t in range(1, len(lrs) + 1)]
    far = np.abs(p0) + sum(lr * x for lr, x in zip(lrs, r))  # |p| never exceeds this
    return sum(lr * (x + cfg.weight_decay * far) for lr, x in zip(lrs, r))


def _leaves(tree) -> list:
    return flatten(tree)[0]


def init_state(params, cfg: OptConfig) -> dict:
    """The reference's state tree for ``params`` (nested dicts of tensors),
    on the parameters' devices."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree, dtype=torch.float32)  # a DTensor keeps its placements

    device = _leaves(params)[0].device
    st = {"m": zeros(params), "v": zeros(params),
          "count": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.grad_compression:
        st["ef"] = zeros(params)
    if any(x.dtype != torch.float32 for x in _leaves(params)):
        def copy(tree):
            if isinstance(tree, dict):
                return {k: copy(v) for k, v in tree.items()}
            return tree.detach().to(torch.float32, copy=True)

        st["master"] = copy(params)
    return st


def _slices(x: torch.Tensor) -> list:
    """A leaf as the pieces the update walks: its slices along the leading
    axis when it is stacked (3-D or more), else itself."""
    return list(x.unbind(0)) if x.dim() >= 3 else [x]


def _global_norm(grads: list) -> torch.Tensor:
    """sqrt of the fp32 sum of squares, leaf by leaf in the given order
    (slice by slice within a stacked leaf); a DTensor leaf's sum is reduced
    across the shards that split it."""
    total = 0
    for g in grads:
        leaf = sum(s.float().square().sum() for s in _slices(g))
        total = total + (leaf.full_tensor() if isinstance(leaf, DTensor) else leaf)
    return torch.sqrt(total)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _leaf_max(x: torch.Tensor, like) -> torch.Tensor:
    """The maximum of local ``x`` across the shards of DTensor ``like``."""
    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Partial("max")] * mesh.ndim,
                              run_check=False).full_tensor()


def _compress_ef(g: torch.Tensor, ef: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 quantize ``g + ef`` with error feedback at the leaf's ``scale``
    (``max|g + ef| / 127`` over the whole leaf, clamped at 1e-12 / 127):
    returns the dequantized gradient and leaves the new residual in ``ef``.
    ``round`` is half to even, as ``jnp.round``."""
    t = g + ef
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    torch.sub(t, deq, out=ef)
    return deq


def apply_updates(params, grads, state: dict, step, cfg: OptConfig):
    """One AdamW step, in place on ``params`` and ``state`` (``grads``: the
    parameters' structure or a list in their flatten order). Returns
    ``(params, state, {"grad_norm", "lr"})``; ``grad_norm`` stays on the
    device, ``lr`` is the schedule's float."""
    flat_p = _leaves(params)
    flat_g = grads if isinstance(grads, (list, tuple)) else _leaves(grads)
    flat_m, flat_v = _leaves(state["m"]), _leaves(state["v"])
    flat_ma = _leaves(state["master"]) if "master" in state else [None] * len(flat_p)
    flat_ef = _leaves(state["ef"]) if cfg.grad_compression else [None] * len(flat_p)
    with torch.no_grad():
        gnorm = _global_norm(flat_g)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        lr = schedule(step, cfg)
        state["count"] += 1
        cnt = _local(state["count"]).float()  # a restored count may be a replicated DTensor
        b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=cnt.device), cnt)
        b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=cnt.device), cnt)
        for p, g, m, v, ma, ef in zip(flat_p, flat_g, flat_m, flat_v, flat_ma, flat_ef):
            decay = p.dim() >= 2  # decoupled weight decay on matrices only
            like = p
            if isinstance(p, DTensor):  # the update runs on each rank's shard
                if isinstance(g, DTensor):
                    g = g.redistribute(p.device_mesh, p.placements)
                p, g, m, v, ma, ef = map(_local, (p, g, m, v, ma, ef))
            gsl, masters = _slices(g), (None if ma is None else _slices(ma))
            if ef is not None:  # the int8 scale is the whole leaf's: find it first
                efs = _slices(ef)
                amax = _leaf_max(torch.stack([(gi.float() * scale + e).abs().max()
                                              for gi, e in zip(gsl, efs)]).max(), like)
                ef_scale = torch.clamp(amax, min=1e-12) / 127.0
            for i, (ps, ms, vs) in enumerate(zip(_slices(p), _slices(m), _slices(v))):
                gi = gsl[i].float() * scale
                if ef is not None:
                    gi = _compress_ef(gi, efs[i], ef_scale)
                _update(ps, gi, ms, vs, None if masters is None else masters[i],
                        lr=lr, b1c=b1c, b2c=b2c, cfg=cfg, decay=decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update(p, g, m, v, master, *, lr, b1c, b2c, cfg: OptConfig, decay: bool) -> None:
    """The reference's ``upd`` on one slice, in place: m, v, then the step
    ``m̂ / (sqrt(v̂) + eps)`` (+ weight decay of the fp32 reference value),
    the master (or the fp32 parameter) less ``lr`` times it, and the
    parameter rounded from the master."""
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
    step = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
    ref = master if master is not None else p
    if decay:
        step.add_(ref * cfg.weight_decay)
    step.mul_(lr)
    if master is not None:
        master.sub_(step)
        p.copy_(master)
    else:
        p.sub_(step)
