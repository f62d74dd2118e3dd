"""Hand-written Hopper kernels of the port, each beside its plain twin.

``ALL`` lists every kernel; ``build_all(ALL)`` compiles them in parallel.
"""
from repro_torch.kernels._build import build_all
from repro_torch.kernels.causal_conv.kernel import (
    CAUSAL_CONV,
    CAUSAL_CONV_BWD,
)
from repro_torch.kernels.conv2d.kernel import CONV2D_3X3
from repro_torch.kernels.fft.kernel import FFT_STAGE
from repro_torch.kernels.flash_attention.kernel import (
    FLASH_CARRY,
    FLASH_CARRY_BWD,
)
from repro_torch.kernels.ssd.kernel import SSD_CHUNKS, SSD_CHUNKS_BWD
from repro_torch.kernels.systolic_matmul.kernel import TILE_MATMUL

ALL = (FLASH_CARRY, FLASH_CARRY_BWD, TILE_MATMUL, SSD_CHUNKS, SSD_CHUNKS_BWD,
       CONV2D_3X3, FFT_STAGE, CAUSAL_CONV, CAUSAL_CONV_BWD)

__all__ = ["ALL", "CAUSAL_CONV", "CAUSAL_CONV_BWD", "CONV2D_3X3", "FFT_STAGE",
           "FLASH_CARRY", "FLASH_CARRY_BWD", "SSD_CHUNKS", "SSD_CHUNKS_BWD",
           "TILE_MATMUL", "build_all"]
