"""Distributed radix-4 DIT Cooley-Tukey FFT — the paper's cfft kernel — on
the emulated PE axis.

Paper (§V-C): 256-point complex FFTs, 4 radix-4 stages mapped to 4
pipelined PE groups of 64; twiddles are stage-constant and preloaded
(weight-stationary); the digit-reversed input load and the final store use
the shared-memory path; inter-stage data flows through systolic links.

Here ``fft256_radix4`` is the shared-memory form: the digit-reversed load
and all stages over the whole batch in one ``fft_full`` launch.
``pipelined_fft`` streams microbatches through 4 stage-owning PEs over
open-chain hops (``core/pipeline``), one ``fft_stage`` launch per tick for
all PEs; its ``baseline`` mode is the shared-memory form. Both kernels of
``kernels/fft`` take the twiddle table of all stages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pipeline import index_vector, pipelined
from repro_torch.core.queues import table_cache
from repro_torch.kernels.fft.kernel import FULL_MAX_N, fft_full
from repro_torch.kernels.fft.kernel import fft_stage as stage_kernel


def digit_reverse_indices(n: int, radix: int = 4) -> np.ndarray:
    """Digit-reversed (base-``radix``) index permutation for DIT input."""
    digits = int(round(np.log(n) / np.log(radix)))
    idx = np.arange(n)
    out = np.zeros_like(idx)
    x = idx.copy()
    for _ in range(digits):
        out = out * radix + x % radix
        x //= radix
    return out


def radix4_butterfly(a, b, c, d):
    """4-point DFT of (a,b,c,d) (complex). Returns the 4 outputs."""
    t0 = a + c
    t1 = a - c
    t2 = b + d
    t3 = (b - d) * (-1j)
    return t0 + t2, t1 + t3, t0 - t2, t1 - t3


def stage_twiddles(n: int, stage: int, n_stages: int) -> np.ndarray:
    """Twiddle factors for DIT stage ``stage`` (0 = first after digit-rev).

    At stage s the transform size is L = 4^(s+1); within each block of size
    L, output leg j of sub-block r gets twiddle W_L^(r*j), applied to the
    inputs of the butterfly (standard Cooley-Tukey).
    """
    L = 4 ** (stage + 1)
    quarter = L // 4
    k = np.arange(n) % L
    r = k % quarter
    j = k // quarter                       # which butterfly leg 0..3
    return np.exp(-2j * np.pi * (r * j) / L)


def n_stages_of(n: int) -> int:
    stages = int(round(np.log(n) / np.log(4)))
    if n < 4 or 4 ** stages != n:
        raise ValueError(f"radix-4 FFT needs a power of 4 points, got {n}")
    return stages


@table_cache(maxsize=16)
def twiddle_table(n: int, device) -> torch.Tensor:
    """[D, n] complex64: row s holds stage s's twiddles. Cached per device:
    the stage-stationary operand is loaded once."""
    d = n_stages_of(n)
    tw = np.stack([stage_twiddles(n, s, d) for s in range(d)])
    return torch.as_tensor(tw.astype(np.complex64), device=device)


def fft256_radix4(x, n: int = 256):
    """Batched n-point FFT via the radix-4 DIT stages. x: [..., n]
    complex64. One ``fft_full`` launch for n <= 4096 (``FULL_MAX_N``, a
    row in shared memory); a larger n runs D stage launches, the first
    loading digit-reversed."""
    tw = twiddle_table(n, x.device)
    if n <= FULL_MAX_N:
        return fft_full(x.reshape(-1, n), tw).reshape(x.shape)
    y = x.reshape(1, -1, n)
    for s in range(n_stages_of(n)):
        y = stage_kernel(y, index_vector((s,), x.device), tw,
                         reverse=(s == 0))
    return y.reshape(x.shape)


def fft_stage(x, stage: int, n: int = 256):
    """One radix-4 stage (the per-PE program of stage group ``stage``).
    x: [..., n] complex64."""
    y = stage_kernel(x.reshape(1, -1, n), index_vector((stage,), x.device),
                     twiddle_table(n, x.device))
    return y.reshape(x.shape)


def pipelined_fft(xs, n_pe: int, mode: str = "qlr", n: int = 256):
    """Stage-pipelined FFT: PE s runs stage s for a stream of FFT
    microbatches (the paper's 4x64 PE pipeline); stage 0 also does the
    digit-reversed load. xs: [M, batch, n] complex64 -> [M, batch, n].

    ``n_pe`` must equal the stage count (4 for n = 256): with more PEs the
    reference clips the stage index and applies the last stage again,
    which is no FFT, so this raises instead. ``baseline`` (no hops, the
    shared-memory form) is ``fft256_radix4`` over all microbatches: one
    launch instead of one per stage, with the same values."""
    d = n_stages_of(n)
    if n_pe != d:
        raise ValueError(f"pipelined_fft runs one stage per PE: n_pe must "
                         f"be {d} for {n} points, got {n_pe}")
    if mode == "baseline":
        return fft256_radix4(xs, n)
    tw = twiddle_table(n, xs.device)

    def stage_fn(_params, x, stage_idx):
        return stage_kernel(x, stage_idx, tw, reverse=True)

    return pipelined(stage_fn, n_pe, xs.shape[0], mode)(None, xs)
