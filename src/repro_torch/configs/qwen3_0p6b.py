"""qwen3-0.6b: dense, qk-norm, GQA. [hf:Qwen/Qwen3-8B family; hf]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B; hf]",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    norm_type="rmsnorm",
    qk_norm=True,
    rope_theta=1000000.0,
    mlp_kind="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    norm_type="rmsnorm",
    qk_norm=True,
    mlp_kind="swiglu",
    tie_embeddings=True,
)
