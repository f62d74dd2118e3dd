"""Paper-native workload suite: the three MemPool DSP kernels.

The paper evaluates matmul / conv2d / cfft on a 256-PE cluster. These
configs size the DSP runs (``core/halo``, ``core/pipeline``, ``core/fft``,
``core/collective_matmul.cannon_matmul``); they are not LM architectures.
Names and defaults are those of the reference ``repro/configs/mempool_dsp.py``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class DSPConfig:
    name: str
    kind: str                  # matmul | conv2d | cfft
    # matmul: C[M,P] = A[M,N] @ B[N,P]
    M: int = 256
    N: int = 256
    P: int = 256
    # conv2d: image [H,W] * 3x3 kernel
    H: int = 256
    W: int = 256
    # cfft: batched 256-point complex FFTs
    fft_points: int = 256
    fft_batch: int = 64
    dtype: str = "float32"


MATMUL = DSPConfig(name="mempool-matmul", kind="matmul", M=256, N=256, P=256)
CONV2D = DSPConfig(name="mempool-conv2d", kind="conv2d", H=256, W=256)
CFFT = DSPConfig(name="mempool-cfft", kind="cfft", fft_points=256, fft_batch=64)
