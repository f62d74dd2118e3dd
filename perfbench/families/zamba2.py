"""``zamba2``: the published Zamba2. Every layer a Mamba2 layer
(``families/ssm.mamba2_layer``); each call of a shared block (one a layer
of ``hybrid_layer_ids`` below ``num_layers``) counts the block's weights
again: Q, K and V of the 2 d_model-wide input, the output projection, the
gated-GELU MLP's gate/up and down, the call's own gate/up adapter and the
layer's own ``linear`` (no norm scales)."""
from __future__ import annotations

from perfbench.families.ssm import mamba2_layer


def shared_call(m: dict) -> int:
    d, f, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    hd = m["num_heads"] * m["head_dim"]
    qkv = 2 * d * (hd + 2 * m["num_kv_heads"] * m["head_dim"])
    return qkv + hd * d + 3 * d * f + r * (d + 2 * f) + d * d


def body_weights(config: dict) -> int:
    m = config["model"]
    calls = sum(i < m["num_layers"] for i in m["hybrid_layer_ids"])
    return m["num_layers"] * mamba2_layer(m) + calls * shared_call(m)
