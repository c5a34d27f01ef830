"""The table of peaks one NVIDIA H100 SXM issues, and the least time of a
piece of work at them.

Published (NVIDIA's data sheet, dense, at the 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores (an FMA counted as two), 3.35 TB/s of HBM.
Integer work issues at the SM's full rate, 128 lanes an SM a clock:
132 SMs x 128 x 1,980 MHz = 33.46 T instructions/s (the INT32 lanes alone
give half that, a rate a kernel can beat by issuing integer work on the
other lanes, so it is no bound). Integer and float work share the issue.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
INT_ISSUE = 132 * 128 * 1.980e9


def least_ms(int_ops: float = 0.0, float_ops: float = 0.0, nbytes: float = 0.0) -> float:
    """The larger of the operations at their fastest issue and the bytes at
    HBM bandwidth, in ms."""
    ops_s = int_ops / INT_ISSUE + float_ops / FP32_FLOPS
    return max(ops_s, nbytes / HBM_BYTES) * 1e3
