"""Kernel K1 (``csrc/nn_tc.cu``, the exact brute-force matcher) against its
bound at the cell's shapes, in percent: the bound of one call, the larger
of its bytes (each input read once, each output written once) over the
HBM peak and its float32 operations (6 a source-target pair) over the
FP32 peak, over the time of one call, each kernel's mean event time in the
profiled stretch summed over the kernels a call launches (one each)."""

from benchmark import roofline

UNIT = "%"
KERNELS = ("nn_tc_sweep_kernel", "nn_tc_finish_kernel")


def read(run):
    call_us = roofline.call_us(run.trace, KERNELS)
    if call_us is None:
        return None
    s = run.shapes
    bound_ms = roofline.brute_bound_ms(s["batch"], s["source_rows"],
                                       s["target_rows"])
    return 100.0 * bound_ms * 1e3 / call_us
