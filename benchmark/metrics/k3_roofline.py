"""Kernel K3 (``csrc/morton.cu``, the Morton band matcher) against its
bound at the cell's shapes, in percent: the bound over the band that the
configuration defines, every source row against ``band_rows(chunk,
window)`` targets whatever the kernel culls (6 float32 operations a pair
over the FP32 peak, or its bytes over the HBM peak), over the mean time of
its one kernel a call in the profiled stretch."""

from benchmark import roofline

UNIT = "%"
KERNELS = ("morton_band_kernel",)


def read(run):
    call_us = roofline.call_us(run.trace, KERNELS)
    if call_us is None:
        return None
    s = run.shapes
    bound_ms = roofline.band_bound_ms(s["batch"], s["source_rows"],
                                      s["target_rows"], s["chunk"],
                                      s["window"])
    return 100.0 * bound_ms * 1e3 / call_us
