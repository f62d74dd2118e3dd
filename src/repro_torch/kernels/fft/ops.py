"""The reference's kernel-level FFT contract ``fft256(x [B, n])``: the
digit-reversed load and the four stages of ``core/fft.fft256_radix4``, one
``fft_full`` launch."""
from __future__ import annotations

from repro_torch.core.fft import fft256_radix4


def fft256(x, *, n: int = 256):
    """x: [B, n] complex64 -> its FFT over the last axis."""
    return fft256_radix4(x, n)
