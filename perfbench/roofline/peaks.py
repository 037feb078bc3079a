"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit): HBM bandwidth, and the rate of scalar f64 / i32
compares outside the tensor cores.  The f64 rate is 34 TFLOP/s (half of
f32's 67), which counts a fused multiply-add as two; a compare is one
instruction, so 17e12 compares a second."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_COMPARES_PER_S = 17e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_COMPARES_PER_S)
