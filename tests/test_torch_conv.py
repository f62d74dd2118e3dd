"""Which body of the conv2d kernel the wrapper takes, from shape, type and
data pointers alone (``kernel.conv_strip``, a pure function: no device).

The 16-byte body needs every row of x, the halos and the output to start on
a 16-byte boundary; every other width or alignment takes the generic body.
A PE block of at most 64 rows is one strip; a taller one is cut into strips
of 32 rows.
"""
from __future__ import annotations

import pytest

from repro_torch.kernels.conv2d import kernel as ck

A = 1 << 20          # a 16-byte aligned address
FP32, BF16 = 4, 2


@pytest.mark.parametrize("shape,itemsize,addresses,strip", [
    # the card shapes that launch on the DSP paths
    ((256, 32, 8192), FP32, [A, A, A, A], 32),    # conv2d_systolic, 256 PEs
    ((256, 32, 8192), BF16, [A, A, A, A], 32),
    ((8, 512, 8192), FP32, [A, A], 32),           # a chain tick
    ((16, 512, 8192), FP32, [A, A], 32),          # chain baseline
    ((16, 512, 8192), BF16, [A, A], 32),
    ((1, 8192, 8192), FP32, [A, A], 32),          # the baseline's image
    ((1, 8192, 8192), BF16, [A, A], 32),
    # the paper's image on 256 PEs: one row a PE
    ((256, 1, 256), FP32, [A, A, A, A], 1),
    ((256, 1, 256), BF16, [A, A, A, A], 1),
    # a block of exactly 64 rows is one strip, 65 rows are cut
    ((1, 64, 64), FP32, [A, A], 64),
    ((1, 65, 64), FP32, [A, A], 32),
    # at the vector width: 16 / itemsize columns a lane, 4 fp32 or 8 bf16
    ((2, 70, 1024), FP32, [A, A], 32),
    ((2, 70, 1028), FP32, [A, A], 32),
    ((2, 70, 1032), BF16, [A, A], 32),
])
def test_conv_strip_of_aligned_rows(shape, itemsize, addresses, strip):
    assert ck.conv_strip(shape, itemsize, addresses) == strip


@pytest.mark.parametrize("shape,itemsize,addresses", [
    ((256, 32, 8190), FP32, [A, A, A, A]),        # card_ragged
    ((256, 32, 8190), BF16, [A, A, A, A]),
    ((256, 1, 250), FP32, [A, A, A, A]),          # paper_ragged
    ((4, 3, 300), BF16, [A, A]),                  # 300 = 37 vectors + 4
    ((2, 17, 1028), BF16, [A, A]),
    ((2, 70, 1030), FP32, [A, A]),
    ((2, 70, 1030), BF16, [A, A]),
    ((2, 17, 1025), FP32, [A, A]),                # a vector multiple + 1
    ((2, 17, 1023), FP32, [A, A]),                # - 1
    ((2, 5, 1024), FP32, [A + 8, A]),             # x off by two fp32
    ((2, 5, 1024), BF16, [A + 2, A]),             # x off by one bf16
    ((2, 5, 1024), FP32, [A, A + 4, A, A]),       # a halo off by one fp32
    ((2, 5, 1024), FP32, [A, A, A, A + 4]),       # the output
])
def test_conv_strip_takes_the_generic_body(shape, itemsize, addresses):
    assert ck.conv_strip(shape, itemsize, addresses) == 0
