"""``ssm``: a stack of Mamba2 layers (in_proj, the depthwise causal conv,
out_proj; no norm scales, biases or per-head scalars)."""
from __future__ import annotations


def mamba2_layer(m: dict) -> int:
    d = m["d_model"]
    d_in = m["ssm_expand"] * d
    gn = m["ssm_ngroups"] * m["ssm_state"]
    heads = d_in // m["ssm_headdim"]
    conv = (d_in + 2 * gn) * m["ssm_conv_kernel"]
    return d * (2 * d_in + 2 * gn + heads) + conv + d_in * d


def body_weights(config: dict) -> int:
    m = config["model"]
    return m["num_layers"] * mamba2_layer(m)
