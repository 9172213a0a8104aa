"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, without
sparsity), at its full 700 W power limit. Every share of a peak or a roofline
is stated against these; the run prints the card's name and power limit."""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12

PEAK = {"int8": INT8_OPS_PER_S, "bf16": BF16_OPS_PER_S}


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The roofline: the larger of the operations at the precision's peak and
    the bytes at the memory's bandwidth."""
    return max(ops / PEAK[precision], nbytes / HBM_BYTES_PER_S)
