"""Full SSD scan: the intra-chunk kernel pass, the inter-chunk chain and the
inter-chunk output correction.

The port's one implementation of the reference's two (``repro/kernels/ssd/
ops.ssd`` through the Pallas kernel, ``repro/models/ssm.ssd_chunked`` in
plain jnp): both compute one function, and the port's Mamba2 layer runs it
through the kernel. The chain ``entering[c] = entering[c-1] * decay[c-1] +
S[c-1]`` is the systolic chain of the SSD decomposition: a sequential loop
over chunks, or with ``assoc_scan`` a log-depth scan under ``(a1, s1) *
(a2, s2) = (a1 a2, s1 a2 + s2)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_chunks


def _chain(decay, states, init, assoc_scan: bool):
    """States entering each chunk [BH,NC,P,N] and the final state [BH,P,N].
    decay [BH,NC]; states [BH,NC,P,N]; init [BH,P,N]."""
    nc = decay.shape[1]
    if not assoc_scan:
        prev, entering = init, []
        for ci in range(nc):
            entering.append(prev)
            prev = prev * decay[:, ci, None, None] + states[:, ci]
        return torch.stack(entering, 1), prev
    a, s = decay, states.clone()
    s[:, 0] += init * a[:, 0, None, None]
    off = 1
    while off < nc:                                  # inclusive scan
        s_next, a_next = s.clone(), a.clone()
        s_next[:, off:] = s[:, :-off] * a[:, off:, None, None] + s[:, off:]
        a_next[:, off:] = a[:, :-off] * a[:, off:]
        s, a = s_next, a_next
        off *= 2
    return torch.cat([init[:, None], s[:, :-1]], 1), s[:, -1]


def ssd(x, dt, a, b, c, d, *, chunk: int, assoc_scan: bool = False,
        initial_state=None, return_final_state: bool = False):
    """Full SSD. x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a: [H] (<0);
    b, c: [B,S,G,N]; d: [H]; initial_state: [B,H,P,N] or None (zeros).
    Returns y [B,S,H,P] fp32 (and the final state [B,H,P,N] fp32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"ssd: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk
    xk = x.permute(0, 2, 1, 3).reshape(bsz * h, nc, chunk, p)
    dtk = dt.float().permute(0, 2, 1).reshape(bsz * h, nc, chunk, 1)
    ak = a.float()[None].expand(bsz, h).reshape(bsz * h, 1, 1, 1)
    bk = b.permute(0, 2, 1, 3).reshape(bsz * g, nc, chunk, n)
    ck = c.permute(0, 2, 1, 3).reshape(bsz * g, nc, chunk, n)
    y_intra, states, expcum = ssd_chunks(xk, dtk, ak, bk, ck, nheads=h,
                                         ngroups=g)

    init = torch.zeros(bsz * h, p, n, dtype=torch.float32, device=x.device) \
        if initial_state is None \
        else initial_state.float().reshape(bsz * h, p, n)
    entering, final = _chain(expcum[:, :, -1, 0], states, init, assoc_scan)

    # inter-chunk output: y += exp(cum[t]) * C[t] . entering_state, with C
    # broadcast over the heads of its group instead of repeated
    rep = h // g
    c_grp = ck.float().reshape(bsz, g, 1, nc, chunk, n)
    ent = entering.reshape(bsz, g, rep, nc, p, n)
    y_inter = torch.matmul(c_grp, ent.transpose(-1, -2)).reshape(
        bsz * h, nc, chunk, p) * expcum
    y = (y_intra + y_inter).reshape(bsz, h, s, p).permute(0, 2, 1, 3)
    y = y + x.float() * d.float()[None, None, :, None]
    if return_final_state:
        return y, final.reshape(bsz, h, p, n)
    return y
