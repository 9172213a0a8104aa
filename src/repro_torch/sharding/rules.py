"""Logical-axis -> mesh-axis rules, derived per architecture (port of
``repro/sharding/rules.py``, the same rules entry for entry).

Axes (see ``models/common.py``):
  batch     -> DP over ('pod','data') / ('data',)
  seq       -> 'model' (sequence-parallel residual stream)
  act_seq   -> block-internal sequence: 'model' only in context-parallel
               attention mode (neither kv nor q heads divisible by TP)
  heads/kv  -> 'model' when divisible by TP
  mlp/experts/vocab -> 'model'
  cache_seq -> decode KV-cache seq: 'model' when heads can't shard

Selection:
  kv_heads % tp == 0  -> classic head-sharded TP (kv+q heads on 'model')
  num_heads % tp == 0 -> q-head-sharded TP, KV replicated across 'model'
  otherwise           -> context parallelism (shard q sequence)

A partition spec is a plain tuple with one entry per tensor dim, each
``None``, a mesh axis name or a tuple of names, as
``jax.sharding.PartitionSpec``; ``models/common.py:spec_placements`` turns
one into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def attn_mode(cfg: ModelConfig, tp: int) -> str:
    if cfg.mixer == "rwkv6":
        return "feature"  # projections TP'd as features; WKV data-parallel
    if cfg.mixer == "mla":
        return "kv_sharded" if cfg.num_heads % tp == 0 else "context"
    if cfg.num_kv_heads % tp == 0:
        return "kv_sharded"
    if cfg.num_heads % tp == 0:
        return "q_sharded"
    return "context"


def make_rules(cfg: ModelConfig, *, tp: int = 16, multi_pod: bool = False,
               mode: str = "train") -> dict:
    """The logical -> mesh axis rules of ``cfg`` at tensor-parallel degree
    ``tp`` for ``mode`` ('train', 'prefill' or 'decode')."""
    dp = ("pod", "data") if multi_pod else ("data",)
    am = attn_mode(cfg, tp)
    rules = {
        "batch": dp,
        "embed": None,
        # ZeRO-3/FSDP: weight feature dims shard over 'data' in training;
        # serving keeps weights replicated across 'data'
        "w_embed": "data" if mode == "train" else None,
        "layers": None,
        "vocab": "model",
        "mlp": "model",
        "experts": "model",
        "seq": "model" if mode != "decode" else None,
        "act_seq": None,
        "heads": None,
        "kv": None,
        "cache_seq": None,
    }
    if am in ("kv_sharded", "feature"):
        rules["heads"] = "model"
        rules["kv"] = "model" if am == "kv_sharded" else None
    elif am == "q_sharded":
        rules["heads"] = "model"
    else:  # context parallel
        rules["act_seq"] = "model" if mode != "decode" else None
    if mode == "decode":
        # the cache shards its seq dim only where heads cannot shard: a
        # kv-sharded cache shards kv heads, MLA's latent cache and a
        # q-sharded model's few kv heads replicate
        if am not in ("kv_sharded", "q_sharded") and cfg.mixer != "mla":
            rules["cache_seq"] = "model"
    return rules


def cnn_serve_rules(*, multi_pod: bool = False) -> dict:
    """Batch-only rules for the CNN serving tier: the aggregated batch
    data-parallels over ('data',), or ('pod', 'data') across pods, while
    the weights stay replicated per device."""
    return {"batch": ("pod", "data") if multi_pod else ("data",)}


def data_pspec(rules) -> tuple:
    """The spec of a batch's leading dim: ``(rules["batch"],)``."""
    return (rules["batch"],)
