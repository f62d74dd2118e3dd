"""qwen3-14b: dense, qk-norm, GQA. [hf:Qwen/Qwen3-8B family; hf]

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B; hf]",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    norm_type="rmsnorm",
    qk_norm=True,
    rope_theta=1000000.0,
    mlp_kind="swiglu",
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    norm_type="rmsnorm",
    qk_norm=True,
    mlp_kind="swiglu",
)
