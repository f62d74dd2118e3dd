"""mixtral-8x22b: MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

56L d_model=6144 48H (GQA kv=8) expert d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="[arXiv:2401.04088; hf]",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    d_ff_expert=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,      # bounded KV cache
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    rope_theta=1000000.0,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    d_ff_expert=128,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    sliding_window=16,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    capacity_factor=2.0,
)
