"""The benchmark's own model FLOPs, frozen: 2 operations per weight a token
passes through, counted at every call of a weight, weights only (no norm
scales, biases or per-head scalars, and no attention score products).
The weights below the head come from the configuration's family
(``perfbench/families/<family>.py``); how many positions pass the body
and the head, and the backward's share, from the traffic kind
(``perfbench/kinds/<kind>.py``'s ``model_flops``).

The port's ``roofline/analysis.model_flops`` counts the prefill head at
every position, so it is not used.
"""
from __future__ import annotations

import importlib

from perfbench import kinds


def body_weights(config: dict) -> int:
    """Weights a token passes through below the head."""
    family = config["model"]["family"]
    return importlib.import_module(
        f"perfbench.families.{family}").body_weights(config)


def per_call(config: dict, traffic: dict) -> float:
    """Model FLOPs of one call (a prefill call or a training step)."""
    m = config["model"]
    return kinds.load(traffic["kind"]).model_flops(
        body_weights(config), m["d_model"] * m["vocab_size"], traffic)
