"""olmo-1b: dense, non-parametric LayerNorm. [arXiv:2402.00838; hf]

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    source="[arXiv:2402.00838; hf]",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_ln",   # OLMo: LayerNorm without scale/bias
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    norm_type="nonparam_ln",
    mlp_kind="swiglu",
    tie_embeddings=True,
)
