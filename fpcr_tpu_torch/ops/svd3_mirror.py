"""Kernel svd3's design (``csrc/svd3.cu``, ``svd3_one``) on the CPU, in
numpy, statement for statement: the CPU tests' mirror of the kernel, which
runs on the card only, and the card tests' reference for it.

The float32 sweeps are computed in ``np.float32`` and the polish and the
completion in float64, as the kernel computes them. Two things differ from
the card by rounding alone: the card contracts a product and a sum into one
FMA, and its ``rsqrtf`` is within 2 ulp (here the correctly rounded
reciprocal square root). Either can change a float32 sweep's last bits, or
which float32 sweep the stop test ends on; the float64 polish converges to
the same R all the same (``tests/test_torch_gpu.py`` holds the kernel to
this mirror within one float32 ulp where R is unique).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SWEEPS = 8  # csrc/svd3.cu: kSweeps, each stage's cap
RANK_TOL = 1e-13  # csrc/svd3.cu: kRankTol
TOL32 = np.float32(2.0 ** -40)  # csrc/svd3.cu: kTol32, ε = 2⁻²⁰ squared
TOL64 = 2.0 ** -104  # csrc/svd3.cu: kTol64, ε = 2⁻⁵² squared
PAIRS = ((0, 1), (0, 2), (1, 2))


class Sweeps(NamedTuple):
    """The sweeps one matrix took: those that rotated, in each stage, and
    whether each stage ended on a sweep that rotated nothing (else at its
    cap)."""

    f32: int
    f64: int
    f32_converged: bool
    f64_converged: bool


def _rsqrt(x):
    """``rsqrtf`` / ``rsqrt`` in the type of ``x``."""
    if isinstance(x, np.float32):
        return np.float32(1.0 / np.sqrt(np.float64(x)))
    return 1.0 / np.sqrt(x)


def rotate(a, v, p: int, q: int, tol) -> bool:
    """``csrc/svd3.cu::rotate``: one rotation of the columns ``p``, ``q`` of
    ``a``, applied to ``v`` too, in place, in the type of ``a``, unless
    γ² <= tol·α·β; returns whether it rotated."""
    t = a.dtype.type
    half = t(0.5)
    alpha = a[0, p] * a[0, p] + a[1, p] * a[1, p] + a[2, p] * a[2, p]
    beta = a[0, q] * a[0, q] + a[1, q] * a[1, q] + a[2, q] * a[2, q]
    gamma = a[0, p] * a[0, q] + a[1, p] * a[1, q] + a[2, p] * a[2, q]
    if not gamma * gamma > tol * (alpha * beta):
        return False
    d, g = beta - alpha, gamma + gamma
    rho = _rsqrt(d * d + g * g)
    h = half + half * abs(d) * rho  # cos²θ
    r = _rsqrt(h)
    c = h * r
    s = np.copysign(half, d) * g * rho * r
    for m in (a, v):
        x, y = m[:, p].copy(), m[:, q].copy()
        m[:, p] = c * x - s * y
        m[:, q] = s * x + c * y
    return True


def sweeps(a, v, tol):
    """``csrc/svd3.cu::sweeps``: sweeps of the three pairs until one
    rotates none, at most ``SWEEPS``; ``(sweeps that rotated, whether a
    sweep rotated none)``."""
    n = 0
    while n < SWEEPS:
        rotated = [rotate(a, v, p, q, tol) for p, q in PAIRS]
        if not any(rotated):
            return n, True
        n += 1
    return n, False


def _reject2(x, u):
    """x − (u·x) u for a unit u, in place; returns |result|²."""
    x -= np.dot(u, x) * u
    return np.dot(x, x)


def _norm_of(x):
    return x * _rsqrt(x) if x > 0.0 else 0.0


def _one(w, det_correction: bool, umeyama: bool, extra: int):
    """The kernel's ``(R, trace, Sweeps)`` of one float32 3x3 ``w``
    (``trace`` None unless ``umeyama``). ``extra`` float64 sweeps follow the
    polish's stop, each pair rotated unless γ = 0 (for the stop test's
    test)."""
    if not np.isfinite(w).all():
        nan = np.full((3, 3), np.nan, np.float32)
        return nan, np.float32(np.nan), Sweeps(0, 0, True, True)
    m = np.abs(w).max()
    e = int(np.frexp(np.float64(m))[1]) if m > 0 else 0
    ws = w.astype(np.float64) * 2.0 ** -e  # exact: a power of two
    a32 = ws.astype(np.float32)
    v32 = np.eye(3, dtype=np.float32)
    n32, ok32 = sweeps(a32, v32, TOL32)

    # V in float64: v1, v2 by Gram-Schmidt, v3 = v1 × v2
    x = v32[:, 0].astype(np.float64)
    y = v32[:, 1].astype(np.float64)
    x = x * _rsqrt(np.dot(x, x))
    ry = _rsqrt(_reject2(y, x))
    v = np.empty((3, 3))
    v[:, 0] = x
    v[:, 1] = y * ry
    v[:, 2] = np.cross(v[:, 0], v[:, 1])
    a = ws @ v  # A = W·V in float64, from W
    n64, ok64 = sweeps(a, v, TOL64)
    for _ in range(extra):
        for p, q in PAIRS:
            rotate(a, v, p, q, 0.0)

    nrm = (a * a).sum(axis=0)
    for p, q in ((0, 1), (1, 2), (0, 1)):  # descending σ
        if nrm[p] < nrm[q]:
            a[:, [p, q]] = a[:, [q, p]]
            v[:, [p, q]] = v[:, [q, p]]
            nrm[[p, q]] = nrm[[q, p]]
    vc = v.T.copy()  # rows: the right singular vectors
    det_v = np.linalg.det(vc)
    tol2 = RANK_TOL * RANK_TOL * nrm[0]
    if not nrm[0] > 0.0:
        u = vc.copy()
    else:
        u = np.empty((3, 3))
        u[0] = a[:, 0] * _rsqrt(nrm[0])
        u[1] = a[:, 1]
        n2 = _reject2(u[1], u[0])
        if not n2 > tol2:  # rank 1
            u[1] = vc[1]
            n2 = _reject2(u[1], u[0])
            if not n2 > 1e-6:
                u[1] = np.eye(3)[int(np.argmin(np.abs(u[0])))]
                n2 = _reject2(u[1], u[0])
        u[1] *= _rsqrt(n2)
        u[2] = det_v * np.cross(u[0], u[1])
        if not det_correction and nrm[2] > tol2 and np.dot(u[2], a[:, 2]) < 0:
            u[2] = -u[2]
    R = (u.T @ vc).astype(np.float32)
    trace = None
    if umeyama:
        d = -1.0 if (nrm[0] > 0.0 and nrm[2] > tol2
                     and np.dot(u[2], a[:, 2]) < 0.0) else 1.0
        trace = np.float32((_norm_of(nrm[0]) + _norm_of(nrm[1])
                            + d * _norm_of(nrm[2])) * 2.0 ** e)
    return R, trace, Sweeps(n32, n64, ok32, ok64)


def svd3_rotation_mirror(W, det_correction: bool = True,
                         extra_sweeps: int = 0) -> np.ndarray:
    """The kernel's R for each 3x3 of ``W`` [..., 3, 3] (float32)."""
    W = np.asarray(W, np.float32)
    out = np.empty(W.shape, np.float32)
    for idx in np.ndindex(W.shape[:-2]):
        out[idx] = _one(W[idx], det_correction, False, extra_sweeps)[0]
    return out


def svd3_umeyama_mirror(W):
    """The kernel's Umeyama form for each 3x3 of ``W`` [..., 3, 3]:
    ``(R, trace)``."""
    W = np.asarray(W, np.float32)
    R = np.empty(W.shape, np.float32)
    trace = np.empty(W.shape[:-2], np.float32)
    for idx in np.ndindex(W.shape[:-2]):
        R[idx], trace[idx], _ = _one(W[idx], True, True, 0)
    return R, trace


def svd3_sweeps(W) -> list:
    """The :class:`Sweeps` of each 3x3 of ``W`` [..., 3, 3], in order."""
    W = np.asarray(W, np.float32)
    return [_one(W[idx], True, False, 0)[2]
            for idx in np.ndindex(W.shape[:-2])]
