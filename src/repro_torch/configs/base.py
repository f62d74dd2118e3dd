"""Configuration dataclasses of the port.

The fields the ported slices read (dense serving and training, Mamba2,
MoE with MLA, the Zamba2 hybrid, the Whisper encoder-decoder and the
InternVL2 patch projector), with the reference's names and defaults
(``repro/configs/base.py``), so a configuration reads the same in both
packages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
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
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    use_attn_bias: bool = False
    mlp_kind: str = "swiglu"       # swiglu | gelu

    # attention flavor
    attention_type: str = "gqa"    # gqa | mla
    sliding_window: int = 0        # 0 -> full attention (mixtral: 4096)

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0         # leading dense layers (DeepSeek-V2: 1)
    d_ff_dense: int = 0            # FF width of those dense layers
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    # split each expert's FFN into k f-slices routed as independent experts
    moe_subexperts: int = 1

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256

    # hybrid (Zamba2): shared attention block interleaved with mamba stack
    attn_every: int = 0            # shared attn block every N mamba layers
    n_shared_attn: int = 0         # number of shared-block invocations

    # encoder-decoder (Whisper)
    enc_layers: int = 0
    enc_frames: int = 1500         # stubbed conv frontend output length
    max_target_positions: int = 448

    # VLM (InternVL2): stubbed ViT patch embeddings
    vit_dim: int = 0
    num_patches: int = 0

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
    # Schedule over the ring: "ring" | "snake_fold" | "torus2d" |
    # "cannon_grid", optionally ":RxC".
    systolic_topology: str = "ring"
    # Tile of the fused consume (0 -> kernel defaults; 64 | 128 force the
    # tile GEMM's output tile, see kernels/systolic_matmul/ops.py).
    kernel_block: int = 0
    # Consult the persistent tuning cache (repro_torch.autotune) for a
    # measured (mode, topology, block) plan per op/shape. Cache-only in the
    # models; online tuning runs through ``autotune.tune``.
    autotune: bool = False

    # activation recomputation of each block in the training backward
    remat: str = "full"            # none | full | selective

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    microbatches: int = 1             # gradient accumulation
    grad_compression: str = "none"    # none | bf16 | fp8sim
    use_master_weights: bool = True
    seed: int = 0
    checkpoint_every: int = 500
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    keep_checkpoints: int = 3
    straggler_deadline_s: float = 0.0  # 0 = watchdog disabled
    log_every: int = 10


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


# ---------------------------------------------------------------------------
# CLI overrides: --set a.b=c
# ---------------------------------------------------------------------------

def _coerce(value: str, target: Any) -> Any:
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    return value


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``field=value`` overrides to a (frozen) dataclass."""
    updates: dict[str, Any] = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        key = key.strip()
        if not hasattr(cfg, key):
            raise KeyError(f"{type(cfg).__name__} has no field {key!r}")
        updates[key] = _coerce(value, getattr(cfg, key))
    return replace(cfg, **updates)
