"""whisper-tiny: encoder-decoder audio model, conv frontend STUB.
[arXiv:2212.04356; unverified]

4L d_model=384 6H (MHA) d_ff=1536 vocab=51865. ``input_specs()`` supplies
precomputed 1500-frame embeddings (the conv1d/mel frontend is stubbed per
the assignment brief).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    source="[arXiv:2212.04356; unverified]",
    num_layers=4,              # decoder layers
    enc_layers=4,
    enc_frames=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    mlp_kind="gelu",
    use_rope=False,            # whisper uses learned/sinusoidal positions
    use_attn_bias=True,
    max_target_positions=448,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke",
    family="encdec",
    num_layers=2,
    enc_layers=2,
    enc_frames=32,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    norm_type="layernorm",
    mlp_kind="gelu",
    use_rope=False,
    use_attn_bias=True,
    max_target_positions=64,
)
