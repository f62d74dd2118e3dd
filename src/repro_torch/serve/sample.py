"""Token sampling for the serving engine.

Edge-case contract (as the reference's serve/sample.py):

* temperature <= 0 — greedy argmax, generator unused.
* NaN logits — treated as -inf, so a partially-NaN row samples its best
  *finite* logit. A fully-NaN (or fully -inf) row yields token 0 in both
  the greedy and the stochastic path.
* top_k >= V (or 0) — no truncation, plain temperature sampling.
* top-k ties at the cutoff — every logit *equal* to the k-th value stays
  sampleable.

Stochastic sampling draws Gumbel noise from the caller's
``torch.Generator`` (argmax of logits + Gumbel is a categorical draw), so
it cannot reproduce the reference's JAX random bits.
"""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: [B, V] -> tokens [B] int32."""
    logits = torch.where(torch.isnan(logits),
                         torch.full_like(logits, -float("inf")), logits)
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k and top_k < logits.shape[-1]:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -float("inf")), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (logits + gumbel).argmax(dim=-1).to(torch.int32)
