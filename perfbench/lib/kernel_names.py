"""Device kernel names, matched as substrings of the profiler's names: the
port's hand-written kernels (``csrc/*.cu``) and the matrix-product
kernels of the libraries PyTorch calls (cuBLAS, cuBLASLt, CUTLASS). A
kernel that is neither is glue: elementwise, copy, reduction, indexing,
softmax and the like."""

HAND_WRITTEN = ("flash_carry_kernel", "flash_carry_bwd_kernel",
                "tile_matmul_kernel", "ssd_chunks_kernel", "ssd_bwd_",
                "conv2d_3x3_kernel", "fft_stage_kernel", "fft_full_kernel")
MATMUL_LIBRARY = ("gemm", "Gemm", "GEMM", "xmma", "cutlass", "nvjet",
                  "cublas", "sm90_", "sm80_", "ampere_", "dot_kernel",
                  "gemv", "splitKreduce")


def kind(name: str) -> str:
    """``hand_written``, ``matmul`` or ``glue``."""
    if any(k in name for k in HAND_WRITTEN):
        return "hand_written"
    if any(k in name for k in MATMUL_LIBRARY):
        return "matmul"
    return "glue"
