"""Configuration dataclasses of the port.

The fields the ported slices read (dense serving and training, Mamba2,
MoE with MLA, the Zamba2 hybrid, the Whisper encoder-decoder and the
InternVL2 patch projector), with the reference's names and defaults
(``repro/configs/base.py``), so a configuration reads the same in both
packages, and the port's own fields of the published Zamba2 layer (the
``zamba2`` family, which the reference lacks); the reference's parameter
counts, shape grid (``ShapeConfig``, ``SHAPES``, ``shape_applicable``) and
``config_summary`` for the dry run. Its ``MeshConfig`` has no
counterpart: the port runs on one card, and its records name the card.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any


# The port's own fields (the published Zamba2 layer), which the
# reference's ModelConfig lacks: every reference configuration holds their
# defaults.
PORT_FIELDS = ("hybrid_layer_ids", "num_mem_blocks", "adapter_rank",
               "attn_scale_frac", "gated_norm_eps")


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

    # published Zamba2 (the zamba2 family; port only): the layers listed
    # (those below num_layers) first call one of num_mem_blocks shared
    # blocks, in turn, each call with its own gate/up adapter of this rank
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 0
    adapter_rank: int = 0
    attn_scale_frac: float = 1.0   # softmax scale 1/sqrt(head_dim * this)
    # the Mamba2 gated RMSNorm's eps (its groups are the ssm_ngroups)
    gated_norm_eps: float = 1e-6

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

    def __post_init__(self):
        # a configuration file's list, held as a tuple (hashable, frozen)
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs accounting)."""
        return _count_params(self)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed-in experts count)."""
        return _count_params(self, active_only=True)


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The reference's analytic parameter count
    (``repro/configs/base.py::_count_params``), formula for formula: it is
    what ``roofline.analysis.model_flops`` counts, so both packages name
    the same work. It is approximate where the reference's is (Zamba2's
    adapters, no norms or biases)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    total = 0
    # embeddings (+ untied LM head)
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        if cfg.attention_type == "mla":
            qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            p = d * cfg.num_heads * qd                       # q proj
            p += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)  # kv down
            p += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim
                                                     + cfg.v_head_dim)
            p += cfg.num_heads * cfg.v_head_dim * d          # out
            return p
        p = d * cfg.num_heads * hd                           # q
        p += 2 * d * cfg.num_kv_heads * hd                   # k, v
        p += cfg.num_heads * hd * d                          # out
        return p

    def mlp_params(ff: int) -> int:
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        return mult * d * ff

    def ssm_params() -> int:
        d_in = cfg.ssm_expand * d
        nheads = d_in // cfg.ssm_headdim
        conv_dim = d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state
        p = d * (2 * d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state
                 + nheads)                                   # in_proj
        p += conv_dim * cfg.ssm_conv_kernel                  # conv1d
        p += nheads * 2                                      # A_log, D
        p += d_in * d                                        # out proj
        return p

    if cfg.family == "ssm":
        total += cfg.num_layers * ssm_params()
    elif cfg.family == "hybrid":
        total += cfg.num_layers * ssm_params()
        total += attn_params() + mlp_params(cfg.d_ff)        # one shared block
        total += cfg.n_shared_attn * 2 * d * d // 8          # adapters
    elif cfg.family == "zamba2":
        calls = sum(i < cfg.num_layers for i in cfg.hybrid_layer_ids)
        qkv = 2 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd  # 2d wide
        total += cfg.num_layers * ssm_params()
        total += cfg.num_mem_blocks * (qkv + cfg.num_heads * hd * d
                                       + 3 * d * cfg.d_ff)   # shared blocks
        total += calls * (cfg.adapter_rank * (d + 2 * cfg.d_ff)
                          + d * d)                           # adapters, linear
    elif cfg.family == "moe":
        n_moe = cfg.num_layers - cfg.first_k_dense
        ff_e = cfg.d_ff_expert or cfg.d_ff
        total += cfg.num_layers * attn_params()
        total += cfg.first_k_dense * mlp_params(cfg.d_ff_dense or cfg.d_ff)
        routed = (cfg.experts_per_token if active_only
                  else cfg.num_experts) * mlp_params(ff_e)
        shared = cfg.num_shared_experts * mlp_params(ff_e)
        router = d * cfg.num_experts
        total += n_moe * (routed + shared + router)
    elif cfg.family == "encdec":
        total += (cfg.enc_layers + cfg.num_layers) * (attn_params()
                                                      + mlp_params(cfg.d_ff))
        total += cfg.num_layers * attn_params()              # cross attention
    else:  # dense / vlm
        total += cfg.num_layers * (attn_params() + mlp_params(cfg.d_ff))
        if cfg.family == "vlm":
            total += cfg.vit_dim * d * 2                     # projector
    return total


# ---------------------------------------------------------------------------
# Input shapes (the reference's grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch x shape) is a valid dry-run cell; reason if not.

    ``long_500k`` needs sub-quadratic attention: it runs for the SSM and
    hybrid families and sliding-window archs, and is skipped for pure
    full-attention archs, as in the reference.
    """
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0
        )
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k skipped"
    return True, ""


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


def _human(n: int) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.2f}B"
    return f"{n / 1e6:.2f}M"


def config_summary(cfg: ModelConfig) -> str:
    n = cfg.n_params
    na = cfg.n_active_params
    lines = [f"{cfg.name} [{cfg.family}] ~{_human(n)} params"]
    if na != n:
        lines.append(f"  active/token ~{_human(na)}")
    lines.append(
        f"  L={cfg.num_layers} d={cfg.d_model} H={cfg.num_heads} "
        f"kv={cfg.num_kv_heads} ff={cfg.d_ff} vocab={cfg.vocab_size}"
    )
    return "\n".join(lines)
