"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), against which a roofline share is read."""

HBM_BYTES_PER_S = 3.35e12     # device memory bandwidth
F32_FLOP_PER_S = 67e12        # float32 outside the tensor cores


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory bandwidth and operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
