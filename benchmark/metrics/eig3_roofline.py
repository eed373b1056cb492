"""Kernel eig3 (``csrc/svd3.cu``, the normals' symmetric 3x3
eigensolver) against its bound at the cell's shapes, in percent: the bound
of one call, the larger of its bytes over the HBM peak and its float32
operations over the FP32 peak (``roofline.bound_ms``), over the mean time
of its events in the profiled stretch (``roofline.call_us``; one launch a
call, on the covariance of every target point).

A matrix reads 36 bytes (9 floats) and writes 48 (3 eigenvalues and 9
eigenvector entries). Its operations are counted as one Jacobi sweep of
the three column pairs, 65 float32 operations a rotation (three dot
products of 3, the angle's 15, the rotation of two 3x3 column pairs' 36):
what a Jacobi solver performs at the least. The bytes bound it."""

from benchmark import roofline

UNIT = "%"
KERNELS = ("eig3_kernel",)
BYTES_PER_MATRIX = 36 + 48
OPS_PER_MATRIX = 3 * 65


def bound_ms(matrices: int) -> float:
    return roofline.bound_ms(matrices * BYTES_PER_MATRIX,
                             matrices * OPS_PER_MATRIX)


def read(run):
    call_us = roofline.call_us(run.trace, KERNELS)
    if call_us is None:
        return None
    s = run.shapes
    return 100.0 * bound_ms(s["batch"] * s["target_rows"]) * 1e3 / call_us
