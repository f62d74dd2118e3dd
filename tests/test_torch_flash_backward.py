"""The flash hop's backward twin (``flash_carry_backward_plain``, the plain
version of ``csrc/flash_carry_bwd.cu``) against autograd of the forward
twin and against the reference's own gradient: ``jax.vjp`` through
``repro.kernels.flash_attention.ops.flash_hop``, whose custom VJP is
``jax.vjp`` of its jnp oracle (the Pallas forward in interpret mode).

Inputs come from numpy with a seed; the bound is fp32 1e-5 of max(1, the
largest gradient). The tied-maximum cases use integer q and k at head_dim
16 (scale 1/4), so that every score is exact in both frameworks: ties are
then ties in both, and a carried m set to a row's block max equals it in
both.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import ref, to_torch  # noqa: F401 (fixture)

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.roofline import count

TOL = 1e-5
NEG = -1e30


def _close(got, want, tol=TOL):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, dtype=np.float32)
        bound = tol * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
        np.testing.assert_allclose(np.asarray(g, dtype=np.float32), w,
                                   rtol=0, atol=bound,
                                   err_msg=f"gradient {i}")


def _inputs(seed, b, sq, t, h, kvh, hd, *, state="carried", bk=None,
            integer=False):
    """numpy q, k, v, (m, l, acc) and cotangents (g_m, g_l, g_acc).
    ``state``: "carried" (a previous hop's), "fresh" (every row at the
    sentinel) or "mixed" (every other row at the sentinel)."""
    rng = np.random.default_rng(seed)
    bk = b if bk is None else bk

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    if integer:
        q = rng.integers(-2, 3, (b, sq, h, hd)).astype(np.float32)
        k = rng.integers(-2, 3, (bk, t, kvh, hd)).astype(np.float32)
    else:
        q, k = rand(b, sq, h, hd), rand(bk, t, kvh, hd)
    v = rand(bk, t, kvh, hd)
    m, l, acc = rand(b, h, sq), np.abs(rand(b, h, sq)) + 1.0, \
        rand(b, h, sq, hd)
    if state == "fresh":
        m, l, acc = np.full_like(m, NEG), np.zeros_like(l), np.zeros_like(acc)
    elif state == "mixed":
        m[::2] = NEG
    cots = (rand(b, h, sq), rand(b, h, sq), rand(b, h, sq, hd))
    return (q, k, v), (m, l, acc), cots


def _per_row(x, b):
    return torch.as_tensor(np.broadcast_to(np.asarray(x), (b,)).copy(),
                           dtype=torch.int32)


def _twin_and_oracle(qkv, st, cots, q_off, k_off, k_len, *, causal, window,
                     kv_row=None, drop=()):
    """(the backward twin's gradients, autograd of the forward twin's) at
    the forward twin's outputs; cotangents whose index is in ``drop`` are
    None (zero)."""
    b = qkv[0].shape[0]
    ins = [to_torch(x) for x in (*qkv, *st)]
    ints = (_per_row(q_off, b), _per_row(k_off, b),
            _per_row(2 ** 30 if k_len is None else k_len, b),
            None if kv_row is None else torch.as_tensor(kv_row))
    ups = [None if i in drop else to_torch(c) for i, c in enumerate(cots)]
    diff = [x.clone().requires_grad_(True) for x in ins]
    outs = fk.flash_carry_plain(*diff, *ints, causal=causal, window=window)
    kept = [(o, u) for o, u in zip(outs, ups) if u is not None]
    want = torch.autograd.grad([o for o, _ in kept], diff,
                               [u for _, u in kept], allow_unused=True)
    want = [torch.zeros_like(x) if w is None else w
            for x, w in zip(diff, want)]
    got = fk.flash_carry_backward_plain(
        *ins, *ints, *(o.detach() for o in outs), *ups, causal=causal,
        window=window)
    return got, want


def _reference(qkv, st, cots, q_off, k_off, k_len, *, causal, window, bq,
               bkv, drop=()):
    """``jax.vjp`` of the reference's ``flash_hop`` (interpret mode) in q,
    k, v and the state."""
    from repro.kernels.flash_attention import ops as rops
    args = [jnp.asarray(x) for x in (*qkv, *st)]
    kl = None if k_len is None else jnp.asarray(k_len, jnp.int32)

    def hop(q, k, v, m, l, acc):
        return rops.flash_hop(q, k, v, (m, l, acc), q_offset=q_off,
                              k_offset=k_off, k_len=kl, causal=causal,
                              window=window, bq=bq, bkv=bkv, interpret=True)
    _, vjp = jax.vjp(hop, *args)
    ct = tuple(jnp.zeros_like(jnp.asarray(c)) if i in drop
               else jnp.asarray(c) for i, c in enumerate(cots))
    return [np.asarray(g) for g in vjp(ct)]


CASES = [
    # (b, sq, t, h, kvh, hd, causal, window, q_off, k_off, state, bq, bkv)
    pytest.param(2, 8, 12, 2, 2, 8, True, 0, 12, 4, "carried", 4, 6,
                 id="mha-causal"),
    pytest.param(2, 8, 12, 4, 2, 8, True, 3, 12, 6, "mixed", 4, 6,
                 id="gqa2-window"),
    pytest.param(1, 6, 10, 6, 1, 8, False, 0, 0, 0, "carried", 6, 5,
                 id="gqa6-noncausal"),
    pytest.param(1, 16, 24, 4, 2, 64, True, 0, 16, 4, "mixed", 8, 8,
                 id="hd64-gqa2"),
    pytest.param(1, 8, 16, 2, 2, 128, True, 0, 8, 0, "carried", 8, 8,
                 id="hd128-mha"),
    pytest.param(2, 8, 12, 4, 2, 8, True, 0, 0, 12, "mixed", 4, 6,
                 id="all-keys-masked"),
    pytest.param(2, 8, 12, 4, 2, 8, True, 0, 0, 12, "fresh", 4, 6,
                 id="all-masked-fresh"),
    pytest.param(2, 8, 8, 4, 2, 8, True, 0, 0, 0, "fresh", 4, 4,
                 id="diagonal-fresh"),
]


@pytest.mark.parametrize(
    "b,sq,t,h,kvh,hd,causal,window,q_off,k_off,state,bq,bkv", CASES)
def test_backward_twin_vs_autograd_and_reference(ref, b, sq, t, h, kvh, hd,
                                                 causal, window, q_off,
                                                 k_off, state, bq, bkv):
    qkv, st, cots = _inputs(0, b, sq, t, h, kvh, hd, state=state)
    got, want = _twin_and_oracle(qkv, st, cots, q_off, k_off, None,
                                 causal=causal, window=window)
    _close([g.numpy() for g in got], [w.numpy() for w in want])
    _close([g.numpy() for g in got],
           _reference(qkv, st, cots, q_off, k_off, None, causal=causal,
                      window=window, bq=bq, bkv=bkv))


def test_backward_twin_per_row_klen(ref):
    """A per-row key bound (the ring decode's ``pos + 1`` and the padded
    tails), one row with no key at all."""
    qkv, st, cots = _inputs(1, 3, 4, 8, 4, 2, 8, state="mixed")
    klen = np.array([3, 8, 0], np.int32)
    got, want = _twin_and_oracle(qkv, st, cots, 2, 0, klen, causal=False,
                                 window=0)
    _close([g.numpy() for g in got], [w.numpy() for w in want])
    _close([g.numpy() for g in got],
           _reference(qkv, st, cots, 2, 0, klen, causal=False, window=0,
                      bq=4, bkv=4))


@pytest.mark.parametrize("drop", [(0,), (1,), (2,), (0, 1)],
                         ids=["no-g_m", "no-g_l", "no-g_acc", "g_acc-only"])
def test_backward_twin_none_cotangent(ref, drop):
    """A cotangent that is None counts as zero."""
    qkv, st, cots = _inputs(2, 2, 8, 12, 4, 2, 8, state="mixed")
    got, want = _twin_and_oracle(qkv, st, cots, 12, 4, None, causal=True,
                                 window=0, drop=drop)
    _close([g.numpy() for g in got], [w.numpy() for w in want])
    _close([g.numpy() for g in got],
           _reference(qkv, st, cots, 12, 4, None, causal=True, window=0,
                      bq=4, bkv=6, drop=drop))


@pytest.mark.parametrize("rows", ["identity", "repeated"])
def test_backward_twin_kv_row(ref, rows):
    """``kv_row``: each query row reads its own K/V row, or (``baseline``
    mode's repeat) two query rows share one, whose dK and dV sum theirs;
    the reference reads the K/V rows expanded, and its gradients in them
    are summed back."""
    b = 4
    kv_row = np.arange(b) if rows == "identity" else np.array([1, 0, 1, 0])
    bk = b if rows == "identity" else 2
    qkv, st, cots = _inputs(3, b, 8, 12, 4, 2, 8, state="mixed", bk=bk)
    got, want = _twin_and_oracle(qkv, st, cots, 12, 4, None, causal=True,
                                 window=0, kv_row=kv_row)
    _close([g.numpy() for g in got], [w.numpy() for w in want])
    q, k, v = qkv
    r = _reference((q, k[kv_row], v[kv_row]), st, cots, 12, 4, None,
                   causal=True, window=0, bq=4, bkv=6)
    for i in (1, 2):
        summed = np.zeros((bk, *r[i].shape[1:]), np.float32)
        np.add.at(summed, kv_row, r[i])
        r[i] = summed
    _close([g.numpy() for g in got], r)


@pytest.mark.parametrize("state", ["carried", "mixed"])
def test_backward_twin_tied_maxima(ref, state):
    """Integer q and k at head_dim 16: exact scores, so several keys tie
    each row's block max (two keys are also copies of each other), and
    the carried m of every third row is set to its block max (half of the
    max route to m, half split among the ties), of others just above and
    below it."""
    b, sq, t, h, kvh, hd = 2, 6, 10, 4, 2, 16
    qkv, st, cots = _inputs(4, b, sq, t, h, kvh, hd, state=state,
                            integer=True)
    q, k, v = qkv
    k[:, 7] = k[:, 2]                             # two keys with equal scores
    g = h // kvh
    s = np.einsum("bsgkd,btkd->bkgst", q.reshape(b, sq, kvh, g, hd), k) \
        .reshape(b, h, sq, t) * np.float32(0.25)
    top = s.max(axis=-1)
    m = st[0].copy()
    m[:, :, 0::3] = top[:, :, 0::3]
    m[:, :, 1::3] = np.where(m[:, :, 1::3] > NEG, top[:, :, 1::3] + 0.5, NEG)
    m[:, :, 2::3] = np.where(m[:, :, 2::3] > NEG, top[:, :, 2::3] - 0.5, NEG)
    st = (m, *st[1:])
    ties = (s == top[..., None]).sum(axis=-1)
    assert (ties > 1).any() and (m == top).any()
    got, want = _twin_and_oracle((q, k, v), st, cots, 0, 0, None,
                                 causal=False, window=0)
    _close([g_.numpy() for g_ in got], [w.numpy() for w in want])
    _close([g_.numpy() for g_ in got],
           _reference((q, k, v), st, cots, 0, 0, None, causal=False,
                      window=0, bq=6, bkv=5))


def test_function_backward_runs_the_twin_once_on_the_cpu():
    """On the CPU, ``flash_hop`` goes through ``_FlashCarry``: its backward
    is the backward twin (bit for bit), and a counter records one
    ``flash_carry_bwd`` launch with its work and none of the twin's ops."""
    qkv, st, cots = _inputs(5, 2, 8, 12, 4, 2, 8, state="mixed")
    ins = [to_torch(x).requires_grad_(True) for x in (*qkv, *st)]
    ups = [to_torch(c) for c in cots]
    with count.Counter() as c:
        outs = fops.flash_hop(*ins[:3], tuple(ins[3:]), q_offset=12,
                              k_offset=4)
        got = torch.autograd.grad(outs, ins, ups)
    agg = c.aggregate()
    flops, moved, _ = fk.backward_work(ins[0], ins[1], ins[3], ins[5])
    assert agg["by_kernel"]["flash_carry_bwd"] == {
        "launches": 1, "flops": flops, "bytes": moved}
    assert agg["by_kernel"]["flash_carry"]["launches"] == 1
    # only the wrapper's per-row offsets (``aten.full``), no twin's op
    assert set(agg["by_op"]) <= {"aten.full"}
    b = ins[0].shape[0]
    want = fk.flash_carry_backward_plain(
        *(x.detach() for x in ins), _per_row(12, b), _per_row(4, b),
        _per_row(2 ** 30, b), None, *(o.detach() for o in outs), *ups,
        causal=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_function_backward_refuses_normalize():
    """The reference defines no gradient for ``normalize=True``: the
    forward runs, its backward raises rather than differentiate a twin."""
    qkv, st, _ = _inputs(6, 1, 4, 8, 2, 2, 8)
    ins = [to_torch(x).requires_grad_(True) for x in (*qkv, *st)]
    outs = fk.flash_carry(*ins, _per_row(8, 1), _per_row(0, 1),
                          _per_row(2 ** 30, 1), normalize=True)
    with pytest.raises(NotImplementedError, match="normalize"):
        torch.autograd.grad(outs[2].sum(), ins)


def test_backward_work_counts_twelve_d_a_pair():
    """12·D operations per (query, head, key) pair, the reference VJP's
    count; the bytes of every input and output once."""
    bf = torch.bfloat16
    q = torch.empty(2, 8, 4, 64, dtype=bf, device="meta")
    k = torch.empty(2, 12, 2, 64, dtype=bf, device="meta")
    m = torch.empty(2, 4, 8, device="meta")
    acc = torch.empty(2, 4, 8, 64, device="meta")
    flops, moved, kind = fk.backward_work(q, k, m, acc)
    assert (flops, kind) == (12 * 64 * 4 * 2 * 8 * 12, "bf16")
    assert moved == 2 * 2 * 8 * 4 * 64 * 2 + 4 * 2 * 12 * 2 * 64 * 2 \
        + 8 * 2 * 4 * 8 * 4 + 4 * 2 * 4 * 8 * 64 * 4
    assert fk.backward_work(q, k, m, acc, pairs=0)[0] == 0


# pass B's split plan of the tensor-core backward (``backward_nsplit``,
# ``backward_shares``): pure functions of the shapes and ``start``. An H100
# holds 132 SMs; pass B's blocks an SM as the card's occupancy reports
# them at head_dim 64, 128 and 224 (one block of two warpgroups an SM).
H100_RESIDENT = {64: 132 * 3, 128: 132 * 2, 224: 132}
# (B', Bk, T, Kv, flattened query rows a (row, KV head), head_dim): hop 1
# of each family's training step, as phase 2 of chip_smoke.py runs them
TRAIN_HOPS = {
    "qwen3": (32, 32, 256, 8, 2 * 256, 128),
    "zamba2": (16, 16, 512, 32, 512, 64),
    "internvl2": (8, 8, 1024, 2, 7 * 1024, 64),
    "mixtral": (4, 4, 512, 8, 6 * 512, 128),
    "whisper": (32, 32, 224, 6, 224, 64),
    "zamba2_7b": (32, 32, 512, 32, 512, 224),
}


@pytest.mark.parametrize("hop", sorted(TRAIN_HOPS))
def test_backward_nsplit_fills_the_card_only_where_needed(hop):
    """No split where pass B's Bk·Kv·⌈T/64⌉ blocks fill two waves of the
    card (qwen3: 1024 blocks, zamba2: 4096); at the GQA hops (256 blocks)
    enough shares for at least 1,000 blocks, within the average query
    tiles of a K/V row over shares of at least ``BWD_SHARE_ITEMS``
    (whisper's 768 blocks, under two waves, hold 4 query tiles a K/V row:
    no split)."""
    bp, bk, t, kvh, rows, d = TRAIN_HOPS[hop]
    resident = H100_RESIDENT[d]
    n = fk.backward_nsplit(bp, bk, t, kvh, rows, resident)
    base = bk * kvh * -(-t // 64)
    cap = min(16, bp * -(-rows // 64) // (bk * fk.BWD_SHARE_ITEMS))
    assert 1 <= n <= max(1, cap)
    if hop in ("qwen3", "zamba2", "whisper", "zamba2_7b"):
        assert n == 1
    if hop in ("internvl2", "mixtral"):
        assert n > 1 and base * n >= 1000
    if base >= 2 * resident:
        assert n == 1
    else:                       # two waves at least, or as many as allowed
        assert base * n >= 2 * resident or n == cap
    assert fk.backward_nsplit(bp, 0, t, kvh, rows, resident) == 1


def test_backward_nsplit_takes_no_split_at_the_zamba2_7b_hop():
    """The zamba2-7b.train cell's hop (Bk 32, Kv 32, T 512, MHA): pass B's
    8,192 blocks fill two waves of any card that holds up to 4,096 of them
    at once, so no resident count up to that splits it."""
    bp, bk, t, kvh, rows, _ = TRAIN_HOPS["zamba2_7b"]
    assert bk * kvh * -(-t // 64) == 8192
    assert {fk.backward_nsplit(bp, bk, t, kvh, rows, resident)
            for resident in range(4097)} == {1}


@pytest.mark.parametrize("d, lanes", [(64, 16), (128, 32), (224, 8)])
def test_backward_prep_lanes_divide_a_warp(d, lanes):
    """The prep pass's lanes a row: D/4 at 64 and 128 (a float4 each), 8
    at 224 (seven float4 each; 56 would not divide a warp); a row's lanes
    cover its D columns in whole float4s, and ``backward_blocks`` counts
    256 // lanes rows a block."""
    assert fk.prep_lanes(d) == lanes
    assert 32 % lanes == 0 and (d // 4) % lanes == 0
    q = torch.empty(32, 512, 32, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(32, 512, 32, d, dtype=torch.bfloat16, device="meta")
    blocks = fk.backward_blocks(q, k, 1)
    assert blocks["prep"] == -(-32 * 32 * 512 // (256 // lanes))
    assert blocks["keys"] == 8 * 32 * 32 and "sum" not in blocks


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("counts", [[1, 1, 1, 1], [4, 0, 2, 1, 0], [0, 0],
                                    [8]])
def test_backward_shares_take_every_item_once_in_order(counts, nsplit):
    """Every (query row, query tile) item of every K/V row falls in exactly
    one share: share s of K/V row kr takes the contiguous items
    [shares[kr, s], shares[kr, s + 1]), the shares in order from 0 to the
    row's item count (``order``'s order), as even as whole items allow
    (zero-count rows give empty shares)."""
    ntile = 5
    start = torch.zeros(len(counts) + 1, dtype=torch.int32)
    start[1:] = torch.cumsum(torch.tensor(counts), 0)
    shares = fk.backward_shares(start, ntile, nsplit)
    assert shares.dtype == torch.int32 and shares.is_contiguous()
    assert tuple(shares.shape) == (len(counts), nsplit + 1)
    for kr, c in enumerate(counts):
        row = shares[kr].tolist()
        assert row[0] == 0 and row[-1] == c * ntile
        assert all(x <= y for x, y in zip(row, row[1:]))
        taken = [n for s in range(nsplit) for n in range(row[s], row[s + 1])]
        assert taken == list(range(c * ntile))
        sizes = [y - x for x, y in zip(row, row[1:])]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("hop, want", [
    # qwen3-0.6b's training hop 1 (PE 0's rows see no key): the bound
    # the first form was held to in phase 2, 0.1214 ms by bytes
    ("qwen3", (38654705664, 406847488, "bf16", 0.12144701134328358,
               "bytes")),
    # internvl2-1b's hop 1: 0.0474 ms by bytes
    ("internvl2", (45097156608, 158859264, "bf16", 0.04742067582089552,
                   "bytes")),
])
def test_backward_work_keeps_the_earlier_bound(hop, want):
    """The redesign does the same work: ``backward_work`` at the live pairs
    of two training hops gives the operations, bytes and bound that the
    kernel's first form was held to (the bound does not move)."""
    from repro_torch.roofline import hw
    bp, _, t, kvh, rows, d = TRAIN_HOPS[hop]
    h, sq = rows // t * kvh, t
    n_pe = 4 if hop == "qwen3" else 2
    pe = torch.arange(n_pe).repeat_interleave(bp // n_pe)
    mask = fk.key_mask(pe * sq, (pe - 1) % n_pe * sq,
                       torch.full((bp,), 2 ** 30), sq, t, causal=True,
                       window=0)
    bf = torch.bfloat16
    q = torch.empty(bp, sq, h, d, dtype=bf, device="meta")
    k = torch.empty(bp, t, kvh, d, dtype=bf, device="meta")
    m = torch.empty(bp, h, sq, device="meta")
    acc = torch.empty(bp, h, sq, d, device="meta")
    flops, moved, kind = fk.backward_work(q, k, m, acc,
                                          pairs=int(mask.sum()))
    assert (flops, moved, kind) == want[:3]
    assert hw.bound_ms(moved, flops, kind) == want[3:]


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("moved", [False, True, "far"])
def test_near_tie_route_follows_the_kernel_only_at_near_ties(moved):
    """``chip_smoke.near_tie_route``: at a row whose two largest scores lie
    within 2^-16 of each other, a backward that sends the max route to the
    other key is held to the twin rerouted alike (and passes); one that
    keeps the twin's route is held to the twin; a route moved at a row
    without a near tie is not rerouted, and fails ``bwd_errors``."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    b, sq, h, t, d = 1, 4, 2, 8, 16
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, t, h, d, generator=g)
    v = torch.randn(b, t, h, d, generator=g)
    row = 2 if moved != "far" else 1          # the query, head 0
    q[0, row, 0] = 3 * k[0, 5, 0] / k[0, 5, 0].norm()
    k[0, 3, 0] = k[0, 5, 0] * (1 + 2 ** -20)  # scores 2^-20 apart
    if moved == "far":                        # no near tie anywhere
        k[0, 3, 0] = k[0, 5, 0] * 0.5
    m = torch.full((b, h, sq), -3.0)
    l = torch.ones(b, h, sq)
    acc = torch.randn(b, h, sq, d, generator=g)
    ints = (torch.tensor([0]), torch.tensor([0]), torch.tensor([t]), None)
    opts = dict(causal=False, window=0)
    args = (q, k, v, m, l, acc, *ints)
    outs = fk.flash_carry_plain(*args, **opts)
    ups = [torch.randn(x.shape, generator=g) for x in outs]
    want = fk.flash_carry_backward_plain(*args, *outs, *ups, **opts)
    got = [x.clone() for x in want]
    scale = fk.softmax_scale(d)
    s = k[0, :, 0] @ q[0, row, 0] * scale
    top, other = int(s.argmax()), 3 if int(s.argmax()) == 5 else 5
    if moved:
        r = ups[0] - ups[1] * outs[1] - (ups[2] * outs[2]).sum(-1)
        w = float(r[0, 0, row])                  # the block max beats m
        got[0][0, row, 0] += w * scale * (k[0, other, 0] - k[0, top, 0])
        got[1][0, other, 0] += w * scale * q[0, row, 0]
        got[1][0, top, 0] -= w * scale * q[0, row, 0]
    ins = (*args[:6], *ints)
    fixed, n = cs.near_tie_route(torch, fk, ins, outs, ups, opts, got, want)
    assert n == (1 if moved is True else 0)
    _, _, ok = cs.bwd_errors(torch, got, fixed)
    assert ok == (moved != "far")
