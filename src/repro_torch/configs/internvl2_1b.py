"""internvl2-1b: InternViT (STUB) + Qwen2-0.5B LM backbone.
[arXiv:2404.16821; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The ViT frontend is
stubbed per the brief: ``input_specs()`` supplies precomputed patch
embeddings (256 patches x 1024 = InternViT-300M width); the model owns the
MLP projector + embedding fusion.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="[arXiv:2404.16821; hf]",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    vit_dim=1024,
    num_patches=256,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=True,
    use_attn_bias=True,        # qwen2 uses qkv bias
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vit_dim=32,
    num_patches=8,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    tie_embeddings=True,
    use_attn_bias=True,
)
