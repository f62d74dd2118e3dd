"""Flash attention over [B, S, H, D] layouts.

``flash_hop`` is the hop-fused form used by ``core/ring_attention``: it
folds one K/V block into carried online-softmax state ``(m, l, acc)`` of
shapes ``[B,H,Sq]``/``[B,H,Sq,hd]`` (the reference's contract) in one
kernel launch. Offsets and the key bound may be scalars or per-row ``[B]``
tensors: the emulated ring folds the PE axis into the batch, so every row
can sit at its own offset.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import NEG_INF, flash_carry

KLEN_NONE = 2 ** 30


def _per_row(x, b: int, device) -> torch.Tensor:
    """Scalar or [B] -> [B] int32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(b)
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def zero_state(b: int, h: int, sq: int, hd: int, device):
    return (torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=device),
            torch.zeros((b, h, sq, hd), dtype=torch.float32, device=device))


def flash_hop(q, k, v, state, *, q_offset=0, k_offset=0, k_len=None,
              causal: bool = True, window: int = 0, kv_rows=None,
              scale=None):
    """One ring hop as one fused kernel launch.

    q:      [B, Sq, H, hd] resident queries.
    k, v:   [Bk, T, Kv, hd] the arriving K/V block (unexpanded GQA); with
            ``kv_rows`` [B], query row b reads K/V row ``kv_rows[b]``.
    state:  (m, l, acc) fp32, [B,H,Sq] / [B,H,Sq] / [B,H,Sq,hd].
    q_offset / k_offset: global position of query / key 0, scalar or [B].
    k_len:  None, scalar or [B]: a key at position p counts iff p < k_len.
    scale:  the scores' scale (None: 1/sqrt(hd)).

    Returns the updated (m, l, acc); the caller normalizes after the last
    hop.
    """
    b = q.shape[0]
    dev = q.device
    m, l, acc = state
    return flash_carry(
        q, k, v, m, l, acc, _per_row(q_offset, b, dev),
        _per_row(k_offset, b, dev),
        _per_row(KLEN_NONE if k_len is None else k_len, b, dev),
        kv_rows, causal=causal, window=window, scale=scale)

