"""Mamba2 LM (mamba2-1.3b). Mirrors ``MambaLM`` of ``repro/models/zamba.py``;
the Zamba2 hybrid is not ported yet.

``params["layers"]`` is a list of per-layer dicts ``{norm, mixer}`` and
the forward is a Python loop over it. The decode cache keeps the
reference's stacked layout, ``{"layers": {"conv": [L,B,K-1,C], "state":
[L,B,H,P,N]}, "pos"}``, so a serving backend zeroes a slot with
``leaf[:, slot] = 0``; each layer writes its slice in place.

Prefill runs each layer's SSD scan through the ``ssd_chunks`` kernel (one
launch per layer). Decode streams one token through the recurrence; the
model has no block prefill into a cache (``prefill_into_cache``), so a
serving engine streams prompts through ``decode_step``, as the reference
does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.common import (
    apply_norm,
    embed,
    init_embedding,
    init_lm_head,
    init_norm,
    lm_logits,
    resolve_device,
)


def init_mamba_block(gen, cfg: ModelConfig):
    return {"norm": init_norm(gen, cfg), "mixer": ssm.init_mamba2(gen, cfg)}


class MambaLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "ssm":
            raise NotImplementedError(f"{cfg.name}: MambaLM takes the ssm "
                                      f"family, got {cfg.family!r}")
        self.cfg = cfg

    def init(self, seed: int = 0, device="cuda"):
        """Random parameters from a seeded ``torch.Generator``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        cfg = self.cfg
        return {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(gen, cfg),
            "head": init_lm_head(gen, cfg),
            "layers": [init_mamba_block(gen, cfg)
                       for _ in range(cfg.num_layers)],
        }

    def hidden_states(self, params, tokens):
        """tokens [B,S] -> final-norm hidden states [B,S,D]."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg)
        for lp in params["layers"]:
            h = apply_norm(lp["norm"], x, cfg)
            x = x + ssm.mamba2_forward(lp["mixer"], h, cfg)
        return apply_norm(params["final_norm"], x, cfg)

    def prefill(self, params, tokens):
        """Forward pass returning last-position logits [B, V]."""
        x = self.hidden_states(params, tokens)
        return lm_logits(params["head"], params["embed"], x[:, -1], self.cfg)

    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        """Per-layer conv window and SSM state (``seq_len`` is unused: the
        state does not grow with the sequence)."""
        dev = resolve_device(device)
        one = ssm.init_mamba2_cache(self.cfg, batch, dev)
        layers = self.cfg.num_layers
        return {"layers": {name: t.unsqueeze(0).repeat(
                    layers, *([1] * t.dim())) for name, t in one.items()},
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def decode_step(self, params, cache, tokens, active=None):
        """tokens: [B,1] -> (logits [B,V], cache). Rows with ``active``
        False keep their state. The cache is updated in place."""
        cfg = self.cfg
        layers = cache["layers"]
        x = embed(params["embed"], tokens, cfg)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(lp["norm"], x, cfg)
            y, new = ssm.mamba2_decode(
                lp["mixer"], h, {k: v[i] for k, v in layers.items()}, cfg,
                active=active)
            for k, v in new.items():
                layers[k][i] = v
            x = x + y
        x = apply_norm(params["final_norm"], x, cfg)
        logits = lm_logits(params["head"], params["embed"], x, cfg)
        cache["pos"] += 1
        return logits[:, 0], cache
