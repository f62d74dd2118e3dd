"""deepseek-v2-lite-16b: MLA + fine-grained MoE. [arXiv:2405.04434; hf]

27L d_model=2048 16H, MLA kv_lora=512, MoE 64 routed experts top-6 +
2 shared, expert d_ff=1408, first layer dense (d_ff 10944), vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="[arXiv:2405.04434; hf]",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,           # MLA: per-head after latent up-projection
    d_ff=1408,                 # routed expert width
    d_ff_expert=1408,
    d_ff_dense=10944,          # layer 0 dense MLP
    first_k_dense=1,
    vocab_size=102400,
    attention_type="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    d_ff_expert=64,
    d_ff_dense=128,
    first_k_dense=1,
    vocab_size=512,
    attention_type="mla",
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    num_experts=8,
    num_shared_experts=2,
    experts_per_token=2,
    norm_type="rmsnorm",
    mlp_kind="swiglu",
    capacity_factor=2.0,
)
