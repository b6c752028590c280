"""The card's peaks and the least time a piece of work can take on it.

Frozen copy of ``chip_smoke.py``'s table (NVIDIA's H100 SXM data sheet,
dense rates, at the full 700 W power limit): HBM3 at 3.35 TB/s, bf16
products at 989 TFLOP/s, fp32 outside the tensor cores at 67 TFLOP/s,
int8 products at 1,979 TOP/s.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def op_seconds(ops: float, dtype: str) -> float:
    """Seconds ``ops`` operations take at the peak rate of ``dtype``."""
    return ops / PEAK_OPS_PER_S[dtype]


def byte_seconds(nbytes: float) -> float:
    """Seconds ``nbytes`` take at the peak memory bandwidth."""
    return nbytes / PEAK_BYTES_PER_S


def bound_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations at the type's peak and the bytes at
    the memory's peak: the least time the card can take."""
    return max(op_seconds(ops, dtype), byte_seconds(nbytes))
