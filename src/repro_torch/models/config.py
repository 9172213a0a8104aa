"""Unified LM configuration (port of ``repro/models/config.py``): every field
of the reference, with dtypes as ``torch.dtype``."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.vdbb import DBBFormat


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # mixer selection; hybrids give a per-layer pattern that tiles num_layers
    mixer: str = "gqa"  # gqa | mla | rwkv6
    block_pattern: Tuple[str, ...] = ("attn",)  # attn | local | rec | rwkv
    local_window: int = 2048

    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.0

    # MLA (deepseek-style)
    q_lora_rank: int = 0  # 0 -> dense q projection
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # recurrent (RG-LRU / RWKV6)
    d_rnn: int = 0  # 0 -> d_model
    conv1d_width: int = 4
    rwkv_head_dim: int = 64
    wkv_chunk: int = 64

    # modality frontends
    frontend: Optional[str] = None  # vision | audio | None
    num_vision_tokens: int = 256
    num_codebooks: int = 4
    codebook_vocab: int = 2048
    cross_attn: bool = False
    cross_len: int = 128

    # --- the paper's technique: VDBB weight sparsity ---
    # Applied to every projection GEMM with K % bz == 0. None = dense model.
    dbb: Optional[DBBFormat] = None
    # serve with compressed DBBWeight leaves (bandwidth win at decode)
    serve_compressed: bool = True
    # the reference's 'ref' | 'pallas' switch of how apply_linear runs a
    # compressed projection; the port routes by device instead (a CPU
    # tensor takes the kernel's plain version, a CUDA tensor the kernel)
    kernel_mode: str = "ref"

    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)

    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"  # none | full | dots (nothing is trained: ignored)
    q_chunk: int = 1024
    scan_layers: bool = True  # the port always loops over groups in Python
    logit_softcap: float = 0.0

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.mixer == "rwkv6":
            return ("rwkv",)
        return self.block_pattern

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        """Layers left over when the pattern doesn't tile num_layers."""
        rem = self.num_layers % len(self.pattern)
        return self.pattern[:rem]

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state size is bounded (SSM/hybrid)."""
        return "attn" not in set(self.pattern)

    def param_count(self) -> int:
        """Weights in the parameter tree (``models.model.lm_defs``)."""
        from repro_torch.models.common import param_leaves
        from repro_torch.models.model import lm_defs

        return sum(math.prod(p.shape) for _, p in param_leaves(lm_defs(self)))

    def active_param_count(self) -> int:
        """Weights a token touches: a MoE's routed expert stacks (the
        ``we_*`` leaves) at ``top_k / num_experts`` of their size, the rest
        whole; every weight of a dense model."""
        from repro_torch.models.common import param_leaves
        from repro_torch.models.model import lm_defs

        total = self.param_count()
        if not self.is_moe:
            return total
        routed = sum(math.prod(p.shape) for path, p in param_leaves(lm_defs(self))
                     if any("we_" in k for k in path))
        return total - routed + routed * self.top_k // self.num_experts
