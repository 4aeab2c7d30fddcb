"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit), and a kernel's share of its roofline.

The share is the least time the work could take on the card (the larger
of its operations over the peak of their precision and its bytes over
HBM's bandwidth) over the device time it took, in percent.  The work is
counted from what the layer's inputs and outputs need (each input byte
read once, each output byte written once), never from the kernel's own
traffic, so a rewrite of the kernel leaves the count as it is.
"""

from __future__ import annotations

F32_OPS = 67e12        # float32 outside the tensor cores, FLOP/s
INT8_OPS = 1979e12     # int8 tensor cores, OP/s
HBM_BYTES = 3.35e12    # bytes/s


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """Least seconds for `nbytes` of traffic and `ops` operations."""
    return max(nbytes / HBM_BYTES, ops / peak_ops)


def share(bound: float, device_s: float):
    """Percent of the roofline, or None where the trace holds no time of
    the kernel (a reader that finds nothing to read returns nothing)."""
    if device_s <= 0:
        return None
    return 100.0 * bound / device_s
