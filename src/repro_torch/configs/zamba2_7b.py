"""zamba2-7b: the published Zamba2 layer (Zamba2-7B-Instruct), the first
18 of its 81 layers. [hf: Zyphra/Zamba2-7B-Instruct config.json]

Every layer is a Mamba2 block (d_model 3584, 112 heads of 64, ssm_state
64, 2 groups, conv 4, chunk 256); the layers of ``hybrid_layer_ids`` (6,
11 and 17 of the 18 kept) first call one of two shared transformer blocks
in turn (block 0 at 6 and 17, block 1 at 11): MHA with 32 heads of 224 over state and embedding concatenated
(7168 wide), RoPE over all 224 dims, softmax scale 1/sqrt(224 / 2), and a
gated-GELU MLP 3584 -> 2 x 14336 -> 3584 with a rank-128 adapter per call
on its gate/up product. The 32000-token vocabulary is tied (the release
config does not list ``tie_word_embeddings``; ``PretrainedConfig``'s
default ties it). The 18 layers (2.25e9 parameters) are one stage of a
pipeline over the 81-layer model, each stage holding both shared blocks.
"""
from repro_torch.configs.base import ModelConfig

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="zamba2",
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
    num_layers=18,             # layers 0-17 of 81
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    rope_theta=10000.0,
    tie_embeddings=True,
    mlp_kind="geglu",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=2,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    hybrid_layer_ids=HYBRID_LAYER_IDS,
    num_mem_blocks=2,
    adapter_rank=128,
    attn_scale_frac=0.5,
    gated_norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="zamba2",
    num_layers=18,             # the same pattern: hybrid at 6, 11, 17
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    mlp_kind="geglu",
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_ngroups=2,
    ssm_conv_kernel=4,
    ssm_chunk=8,
    hybrid_layer_ids=HYBRID_LAYER_IDS,
    num_mem_blocks=2,
    adapter_rank=8,
    attn_scale_frac=0.5,
    gated_norm_eps=1e-5,
)
