"""Configuration dataclasses of the port.

The fields the ported slices read (dense serving, Mamba2), with the
reference's names and defaults (``repro/configs/base.py``), so a
configuration reads the same in both packages. Fields of families the port
does not cover yet (MoE, MLA, hybrid, enc-dec, VLM) are left out until
their slice lands.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"
    source: str = ""

    # transformer backbone
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # norms / embeddings / position
    norm_type: str = "rmsnorm"     # rmsnorm only in this slice
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    use_attn_bias: bool = False
    mlp_kind: str = "swiglu"       # swiglu only in this slice

    # attention flavor
    attention_type: str = "gqa"    # gqa only in this slice
    sliding_window: int = 0        # 0 -> full attention

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256

    # numerics
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "bfloat16"

    # ---- the paper's technique ----
    # baseline: all-gather + one local pass (shared-memory model)
    # xqueue  : hop serialized after the consume
    # qlr     : hop issued before the consume
    # sw      : xqueue plus software circular-buffer bookkeeping per hop
    # Every ring hop's local consume is one call of a kernel wrapper (flash
    # hop / tile matmul): the CUDA kernel on the card, its twin on the CPU.
    systolic_mode: str = "baseline"
    # Schedule over the ring: "ring" | "snake_fold", optionally ":RxC".
    systolic_topology: str = "ring"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 32
    max_seq_len: int = 2048
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    bos_token: int = 0        # seed token for empty prompts
    eos_token: int = -1       # slot retires when it samples this (< 0 = off)
    prefill_chunk: int = 0    # block-prefill up to this many prompt tokens
                              # at admission (0 = stream everything)
