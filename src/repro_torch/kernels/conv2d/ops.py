"""The reference's whole-image contract ``conv2d(x [H, W], kernel)``: the
conv kernel with one block (P = 1) and zero halo rows, the shared-memory
form of the DSP suite's conv2d."""
from __future__ import annotations

from repro_torch.kernels.conv2d.kernel import conv2d_3x3


def conv2d(x, kernel):
    """Zero-padded 3x3 convolution. x: [H, W]; kernel: [3, 3]."""
    return conv2d_3x3(x[None], None, None, kernel)[0]
