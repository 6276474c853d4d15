"""The least time the card could take for a kernel's work: frozen counts.

Peaks are NVIDIA's published dense rates for one H100 SXM at its full
700 W power limit: 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the
tensor cores, 67 TFLOP/s in float64 on its tensor cores (DMMA) and 989
TFLOP/s in bf16. A share of a roofline is stated against them, with the
card's ``power.limit`` recorded beside it by the run.

The bound is the larger of the bytes over the bandwidth and the operations
over the peak (the port's ``chip_smoke.bound``). The counts are of the work
the inputs need, whatever kernel, padding or route does it: each input byte
read once and each output byte written once, and the operations of the rows
that carry weight.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}


def bound_s(bytes_moved: float, flops: float, dtype: str = "float32") -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the least time and what sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_rolling(elements: int, itemsize: int = 4) -> Tuple[float, float]:
    """One rolling reduction (sum, mean or std) over ``elements`` values:
    ``(bytes, operations)``, each value read and its result written once,
    12 operations a value (the std's moments and its finish)."""
    return 2.0 * elements * itemsize, 12.0 * elements


def k2_pair(rows: int, p: int) -> float:
    """Operations of one (universe, column set) Gram over ``rows`` rows of
    nonzero weight and ``p`` predictors: the upper triangle of the
    (p + 2)-square product of [1, x, y], a multiply and an add each."""
    return 2.0 * rows * (p + 2) * (p + 3) / 2.0


def k2_bytes(inputs: Iterable[int], pairs: Iterable[Tuple[int, int]], t: int,
             itemsize: int = 4) -> float:
    """Bytes of one contraction: ``inputs`` (each input's bytes, read once)
    plus a (T, p + 2, p + 2) output a pair (``(rows, p)``), written once."""
    return float(sum(inputs)) + sum(t * (p + 2) ** 2 * itemsize for _, p in pairs)
