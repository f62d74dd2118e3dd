"""Published figures of the card the port runs on, for the roofline and
the kernels' bounds: one NVIDIA H100 SXM 80 GB, from NVIDIA's data sheet
(dense rates, no sparsity). The rates assume the card's full 700 W power
limit; a card set below it runs slower under load, so every measurement
kept beside these figures names the card's power limit.

The reference's constants (TPU v5e, ICI and DCN links) have no one-card
counterpart here.
"""

PART = "NVIDIA H100 SXM 80 GB"
# operations per second, by the type the arithmetic runs in: bf16 and fp16
# on the tensor cores, TF32 on the tensor cores, fp32 outside them
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12}
HBM_BW = 3.35e12                # bytes/s of device memory
HBM_BYTES = 80e9                # device memory


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` operations of type ``kind``: (ms, "bytes" or
    "operations", whichever bounds it)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")
