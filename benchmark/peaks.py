"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): a roofline share is stated against these,
with the card's power limit recorded beside it."""

FP32_FLOPS = 67e12        # float32 outside the tensor cores, FMA = 2
HBM_BYTES = 3.35e12       # device memory, bytes/s


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card can take: operations at the float32 peak or
    bytes at the memory rate, whichever is longer."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)
