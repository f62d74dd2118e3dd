"""The one traffic generator: token ids drawn uniformly from the
vocabulary from the seed, on the device, during set-up.

A traffic file (``traffic/<name>.json``) gives its ``kind`` (``prefill``:
a closed loop of one client, each call a batch of prompts through the
prefill step; ``train``: one training step after another), the ``batch``
of rows and the ``seq`` tokens a row, the set-up calls (``setup_calls``),
the traced calls of a ``--trace 1`` run (``trace_calls``) and how many
calls' rows the pool holds (``pool_calls``). Call i reads slot
i mod ``pool_calls``, so every call has rows of its own as long as the
window makes fewer calls than that. Every seed gives the same shapes and
the same work; only the ids differ.
"""
from __future__ import annotations

import torch

from perfbench.lib.weights import derive


def token_pool(traffic: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """[pool_calls, batch, seq (+1 for training's shifted targets)]."""
    extra = 1 if traffic["kind"] == "train" else 0
    gen = torch.Generator(device=device).manual_seed(derive(seed, "tokens"))
    return torch.randint(0, vocab, (traffic["pool_calls"], traffic["batch"],
                                    traffic["seq"] + extra),
                         generator=gen, device=device)
