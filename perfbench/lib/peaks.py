"""Published figures of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates, no sparsity, at the card's full 700 W limit): the table the
benchmark's shares of a roofline or a peak divide by. A copy of the
port's ``roofline/hw.py`` as it stood when the benchmark was written."""

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12}
HBM_BW = 3.35e12                # bytes/s of device memory


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / HBM_BW, flops / PEAK_FLOPS[kind])
