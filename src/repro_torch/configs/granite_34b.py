"""granite-34b: dense llama-arch code model. [arXiv:2405.04324; hf]

88L d_model=6144 48H (GQA kv=1 -> MQA) d_ff=24576 vocab=49152.

Note: the assigned dims are honored exactly. With the llama-style SwiGLU
MLP this counts ~47B params; the "34B" name corresponds to the released
model's 2-matrix GELU MLP at the same d_ff. We keep SwiGLU (llama-arch per
the assignment tag) and account FLOPs/params from the dims as configured.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="[arXiv:2405.04324; hf]",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,           # multi-query attention
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,      # granite-code ties embeddings
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    tie_embeddings=True,
)
