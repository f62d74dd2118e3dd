"""Hand-written Hopper kernels of the port, each beside its plain twin.

``ALL`` lists every kernel; ``build_all(ALL)`` compiles them in parallel.
"""
from repro_torch.kernels._build import build_all
from repro_torch.kernels.conv2d.kernel import CONV2D_3X3
from repro_torch.kernels.fft.kernel import FFT_STAGE
from repro_torch.kernels.flash_attention.kernel import FLASH_CARRY
from repro_torch.kernels.ssd.kernel import SSD_CHUNKS
from repro_torch.kernels.systolic_matmul.kernel import TILE_MATMUL

ALL = (FLASH_CARRY, TILE_MATMUL, SSD_CHUNKS, CONV2D_3X3, FFT_STAGE)

__all__ = ["ALL", "CONV2D_3X3", "FFT_STAGE", "FLASH_CARRY", "SSD_CHUNKS",
           "TILE_MATMUL", "build_all"]
