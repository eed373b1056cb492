"""Kernel eig3's design (``csrc/svd3.cu``, ``eig3_one``) on the CPU, in
numpy, statement for statement: the CPU tests' mirror of the kernel, which
runs on the card only, and the card tests' reference for it.

It runs svd3's mirror's own ``rotate`` and ``sweeps`` (``svd3_mirror.py``):
the float32 sweeps in ``np.float32``, the shifted float64 polish, the
Rayleigh quotients and the sort in float64. It differs from the card by
rounding alone (the card's FMAs and its ``rsqrtf``), which can change a
float32 sweep's last bits or which sweep the stop test ends on; the polish
converges to the same eigenvectors all the same, within the angle that the
float32 input leaves them (``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import numpy as np

from .eigh3 import ISO_FRAME as _ISO_FRAME, ISO_TOL
from .svd3_mirror import TOL32, TOL64, _reject2, _rsqrt, sweeps

ISO_TOL2 = ISO_TOL * ISO_TOL  # csrc/svd3.cu: kIsoTol2, exact: 2⁻⁴⁴
ISO_FRAME = np.array(_ISO_FRAME)


def _one(A):
    """The kernel's ``(vals [3], vecs [3, 3])`` of one float32 3x3 ``A``."""
    if not np.isfinite(A).all():
        return (np.full(3, np.nan, np.float32),
                np.full((3, 3), np.nan, np.float32))
    m = np.abs(A).max()
    e = int(np.frexp(np.float64(m))[1]) if m > 0 else 0
    As = A.astype(np.float64) * 2.0 ** -e  # exact: a power of two
    a32 = As.astype(np.float32)
    v32 = np.eye(3, dtype=np.float32)
    q = (As[0, 0] + As[1, 1] + As[2, 2]) / 3.0
    iso = ((As - q * np.eye(3)) ** 2).sum() <= ISO_TOL2 * (As * As).sum()
    sweeps(a32, v32, TOL32)

    # V in float64: v1, v2 by Gram-Schmidt, v3 = v1 × v2
    x = v32[:, 0].astype(np.float64)
    y = v32[:, 1].astype(np.float64)
    x = x * _rsqrt(np.dot(x, x))
    ry = _rsqrt(_reject2(y, x))
    v = np.empty((3, 3))
    v[:, 0] = x
    v[:, 1] = y * ry
    v[:, 2] = np.cross(v[:, 0], v[:, 1])
    s = np.abs(As).sum(axis=1).max()  # the shift: the largest row sum
    a = As @ v + s * v  # B·V, B = A + s·I, from A
    sweeps(a, v, TOL64)

    lam = np.array([v[:, j] @ (As @ v[:, j]) for j in range(3)])
    for p, q in ((0, 1), (1, 2), (0, 1)):  # ascending λ
        if lam[p] > lam[q]:
            v[:, [p, q]] = v[:, [q, p]]
            lam[[p, q]] = lam[[q, p]]
    if iso:
        v = ISO_FRAME.copy()
    return (lam * 2.0 ** e).astype(np.float32), v.astype(np.float32)


def eig3_mirror(A):
    """The kernel's ``(vals [..., 3], vecs [..., 3, 3])`` for each 3x3 of
    ``A`` [..., 3, 3] (float32)."""
    A = np.asarray(A, np.float32)
    vals = np.empty(A.shape[:-1], np.float32)
    vecs = np.empty(A.shape, np.float32)
    for idx in np.ndindex(A.shape[:-2]):
        vals[idx], vecs[idx] = _one(A[idx])
    return vals, vecs
