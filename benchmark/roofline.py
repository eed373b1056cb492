"""The yardstick of the kernels' roofline shares: the H100 SXM's published
peaks (NVIDIA's data sheet, dense, at 700 W), the operations and bytes a
matcher call needs at its shapes, and a call's kernel time from a trace.

A bound counts what the inputs need, not what a design executes: 6 float32
operations a (source, target) pair, the norm form's ``|q|^2 - 2 p.q`` with
``|q|^2`` precomputed, as an argmin needs; each input byte read once and
each output byte written once. A tensor-core or culling redesign of a
kernel can beat these bounds: a share above 100% then means the bound, not
the kernel, needs a new definition.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
PAIR_FLOPS = 6
ALIGN = 128


def band_rows(chunk: int, window: int) -> int:
    """Kernel K3's band height: ``round_up(chunk + 2 window + 128, 128)``."""
    return -(-(chunk + 2 * window + ALIGN) // ALIGN) * ALIGN


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3


def brute_bound_ms(b: int, n: int, m: int) -> float:
    """K1 on ``b`` elements of ``n`` sources against ``m`` targets: reads
    both clouds (12 bytes a point), writes an index and a distance (8 bytes
    a source)."""
    return bound_ms(b * (12 * n + 12 * m + 8 * n), b * PAIR_FLOPS * n * m)


def band_bound_ms(b: int, n: int, m: int, chunk: int, window: int) -> float:
    """K3 on ``b`` elements: reads the sorted source and table (12 bytes a
    point), the codes (4 bytes a target) and the bounds, writes the
    matched point, distance and index (20 bytes a source); every source
    row against the whole band."""
    nbytes = b * (12 * n + 12 * m + 4 * m + 28 + 20 * n)
    return bound_ms(nbytes, b * PAIR_FLOPS * n * band_rows(chunk, window))


def call_us(trace, kernels) -> float:
    """The time of one call, in microseconds: for each of the call's
    ``kernels`` (one launch each a call; a name matches as a substring),
    the mean of its events' durations, summed. None if the trace holds no
    event of one of them. A mean, not a sum: a session that drops an event
    then drops neither a call's count nor its time."""
    if trace is None:
        return None
    total = 0.0
    for name in kernels:
        durs = [e - s for n, s, e in trace.device if name in n]
        if not durs:
            return None
        total += sum(durs) / len(durs)
    return total
