"""The 10 assigned LM architectures and ``qwen2-tiny`` (port of
``repro/configs/registry.py``), copied field for field, plus the reduced
smoke variants of the same families.

Every config carries the paper's technique: ``dbb`` defaults to the 3/8 DBB
(62.5 % weight sparsity) with one pattern per matrix (``'matrix'``, the tc
kernels); ``sparsity=None`` / ``'dense'`` gives the dense baseline.
``codeqwen1.5-7b`` keeps the reference's 32 KV heads (the published
CodeQwen1.5-7B config has 4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.vdbb import DBBFormat
from repro_torch.models.config import ModelConfig


def _dbb(sparsity: Optional[Union[str, float]]) -> Optional[DBBFormat]:
    if sparsity in (None, "dense", 0.0):
        return None
    if isinstance(sparsity, str):
        sparsity = float(sparsity)
    nnz = max(1, min(8, round((1.0 - sparsity) * 8)))
    return DBBFormat(8, nnz, "matrix")


_COMMON = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, remat="full")


def qwen2_72b(sparsity=0.625) -> ModelConfig:
    """[arXiv:2407.10671; hf] GQA kv=8, QKV bias."""
    return ModelConfig(
        name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=29568, vocab_size=152064,
        qkv_bias=True, mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
        dbb=_dbb(sparsity), **_COMMON,
    )


def qwen2_5_32b(sparsity=0.625) -> ModelConfig:
    """[hf:Qwen/Qwen2.5-*] GQA kv=8, QKV bias."""
    return ModelConfig(
        name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
        num_heads=40, num_kv_heads=8, d_ff=27648, vocab_size=152064,
        qkv_bias=True, mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
        dbb=_dbb(sparsity), **_COMMON,
    )


def codeqwen1_5_7b(sparsity=0.625) -> ModelConfig:
    """[hf:Qwen/CodeQwen1.5-7B] qwen1.5 arch (MHA, bias)."""
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=32, d_ff=13440, vocab_size=92416,
        qkv_bias=True, mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
        dbb=_dbb(sparsity), **_COMMON,
    )


def starcoder2_7b(sparsity=0.625) -> ModelConfig:
    """[arXiv:2402.19173; hf] GQA kv=4, RoPE, LayerNorm+GELU."""
    return ModelConfig(
        name="starcoder2-7b", family="dense", num_layers=32, d_model=4608,
        num_heads=36, num_kv_heads=4, d_ff=18432, vocab_size=49152,
        qkv_bias=True, mlp="gelu", norm="layernorm", rope_theta=1e5,
        dbb=_dbb(sparsity), **_COMMON,
    )


def deepseek_v3_671b(sparsity=0.625) -> ModelConfig:
    """[arXiv:2412.19437; hf] MLA, 1 shared + 256 routed top-8."""
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
        num_heads=128, num_kv_heads=128, d_ff=2048, vocab_size=129280,
        mixer="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        num_experts=256, top_k=8, num_shared_experts=1,
        mlp="swiglu", norm="rmsnorm", rope_theta=1e4,
        dbb=_dbb(sparsity), **_COMMON,
    )


def moonshot_v1_16b(sparsity=0.625) -> ModelConfig:
    """[hf:moonshotai/Moonlight-16B-A3B] 64e top-6 (+2 shared)."""
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=163840,
        num_experts=64, top_k=6, num_shared_experts=2,
        mlp="swiglu", norm="rmsnorm", rope_theta=5e4,
        dbb=_dbb(sparsity), **_COMMON,
    )


def recurrentgemma_2b(sparsity=0.625) -> ModelConfig:
    """[arXiv:2402.19427; hf] RG-LRU + local attention, 1:2 pattern."""
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
        num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
        block_pattern=("rec", "rec", "local"), local_window=2048, d_rnn=2560,
        mlp="swiglu", norm="rmsnorm", rope_theta=1e4,
        tie_embeddings=True, embed_scale=True, logit_softcap=30.0,
        dbb=_dbb(sparsity), **_COMMON,
    )


def internvl2_2b(sparsity=0.625) -> ModelConfig:
    """[arXiv:2404.16821; hf] InternLM2 backbone; InternViT frontend stubbed."""
    return ModelConfig(
        name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553,
        frontend="vision", num_vision_tokens=256,
        mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
        dbb=_dbb(sparsity), **_COMMON,
    )


def musicgen_medium(sparsity=0.625) -> ModelConfig:
    """[arXiv:2306.05284; hf] decoder-only over EnCodec tokens (4 codebooks),
    cross-attention to text memory; EnCodec frontend stubbed."""
    return ModelConfig(
        name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
        num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048,
        frontend="audio", num_codebooks=4, codebook_vocab=2048,
        cross_attn=True, cross_len=128,
        mlp="gelu", norm="layernorm", rope_theta=1e4,
        dbb=_dbb(sparsity), **_COMMON,
    )


def rwkv6_3b(sparsity=0.625) -> ModelConfig:
    """[arXiv:2404.05892; hf] Finch — data-dependent decay, attention-free."""
    return ModelConfig(
        name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
        num_heads=40, num_kv_heads=40, d_ff=8960, vocab_size=65536,
        mixer="rwkv6", rwkv_head_dim=64,
        norm="layernorm", dbb=_dbb(sparsity), **_COMMON,
    )


def qwen2_tiny(sparsity=0.625) -> ModelConfig:
    """Scaled-down qwen2 shape for CPU-runnable LM serving: the same block
    structure (GQA kv-share, QKV bias, SwiGLU, RMSNorm), fp32 end to end,
    unscanned layers."""
    return ModelConfig(
        name="qwen2-tiny", family="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        qkv_bias=True, mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
        q_chunk=64, remat="none", scan_layers=False,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        dbb=_dbb(sparsity),
    )


ARCHS = {
    "qwen2-72b": qwen2_72b,
    "qwen2.5-32b": qwen2_5_32b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "starcoder2-7b": starcoder2_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "internvl2-2b": internvl2_2b,
    "musicgen-medium": musicgen_medium,
    "rwkv6-3b": rwkv6_3b,
    "qwen2-tiny": qwen2_tiny,
}


def get_config(name: str, sparsity=0.625) -> ModelConfig:
    return ARCHS[name](sparsity=sparsity)


def smoke_config(name: str, sparsity=0.625) -> ModelConfig:
    """The reduced variant of ``name``: same family and blocks, tiny dims."""
    cfg = get_config(name, sparsity=sparsity)
    small = dict(
        num_layers=max(2 * len(cfg.pattern), 2) if len(cfg.pattern) > 1 else 2,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        q_chunk=64,
        wkv_chunk=16,
        remat="none",
        local_window=32,
    )
    if cfg.mixer == "mla":
        small.update(
            num_heads=4, num_kv_heads=4, q_lora_rank=32, kv_lora_rank=32,
            qk_rope_dim=16, qk_nope_dim=16, v_head_dim=16,
        )
    elif cfg.mixer == "rwkv6":
        small.update(num_heads=4, num_kv_heads=4, rwkv_head_dim=32)
    else:
        ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
        small.update(num_heads=4, num_kv_heads=max(1, 4 // ratio), head_dim=32)
    if cfg.is_moe:
        small.update(num_experts=8, top_k=2)
    if cfg.frontend == "vision":
        small.update(num_vision_tokens=8)
    if cfg.cross_attn:
        small.update(cross_len=16)
    if len(cfg.pattern) > 1:
        small["num_layers"] = len(cfg.pattern) * 2 + 2
        small["d_rnn"] = 128
    elif cfg.d_rnn:
        small["d_rnn"] = 128
    return dataclasses.replace(cfg, **small)
