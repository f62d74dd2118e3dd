"""zamba2-1.2b: hybrid Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

38 mamba2 layers d_model=2048, ssm_state=64; one SHARED transformer block
(32H MHA + d_ff=8192 MLP) invoked every 6 mamba layers with per-invocation
low-rank adapters. vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    num_layers=38,             # mamba2 layers
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    attn_every=6,
    n_shared_attn=6,
    norm_type="rmsnorm",
    mlp_kind="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv_kernel=4,
    ssm_chunk=8,
    attn_every=2,
    n_shared_attn=2,
    norm_type="rmsnorm",
    mlp_kind="gelu",
    tie_embeddings=True,
)
