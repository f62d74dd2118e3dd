"""mamba2-1.3b: attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified]

48L d_model=2048, ssm_state=128, headdim=64, expand=2 (d_inner=4096,
64 heads), vocab=50280.

The paper's attention-sharding aspects are inapplicable (attention-free);
the systolic insight maps to the SSD inter-chunk state recurrence, which is
a linear systolic chain (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    norm_type="rmsnorm",
    use_rope=False,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv_kernel=4,
    ssm_chunk=16,
    norm_type="rmsnorm",
    use_rope=False,
    tie_embeddings=True,
)
