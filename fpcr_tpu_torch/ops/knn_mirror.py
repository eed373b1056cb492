"""The self-kNN kernel's selection (``csrc/knn.cu``) on the CPU, in numpy,
step for step: the CPU tests' mirror of the kernel, which runs on the card
only, and the card tests' reference for it.

Each statement of the kernel has its counterpart here, vectorised over
the rows (and the slices): the seed's window around each row, the sweep
over each slice's targets in ascending index with the strict insertion
into a sorted list of ``kk``, the threshold the seed and the list leave,
and the merge of the slices' lists in index order. The distances are the
kernel's, ``(dx·dx + dy·dy) + dz·dz`` with each operation rounded in
float32, so the mirror's output is the kernel's bit for bit, and both are
``ops.normals.knn(q, q, kk, mask, exact=True)``'s whatever the slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .knn_cuda import WINDOW, plan_knn

H100_SMS = 132  # the plan's default: the card's SMs


def _sqdist(p, t):
    """Squared distances of float32 points ``p`` [..., 3] and ``t`` [...,
    3], as the kernel's ``sqdist`` rounds them."""
    dx = p[..., 0] - t[..., 0]
    dy = p[..., 1] - t[..., 1]
    dz = p[..., 2] - t[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def _insert(D, I, d, j, take):
    """The kernel's ``insert`` where ``take``: ``(d, j)`` into the ascending
    lists ``D``, ``I`` [..., kk] after every entry of distance at most d,
    the last entry falling off. In place."""
    kk = D.shape[-1]
    for s in range(kk - 1, 0, -1):
        shift = take & (d < D[..., s - 1])
        place = take & ~shift & (d < D[..., s])
        D[..., s] = np.where(shift, D[..., s - 1], np.where(place, d,
                                                              D[..., s]))
        I[..., s] = np.where(shift, I[..., s - 1], np.where(place, j,
                                                              I[..., s]))
    place = take & (d < D[..., 0])
    D[..., 0] = np.where(place, d, D[..., 0])
    I[..., 0] = np.where(place, j, I[..., 0])


def _empty(shape, kk):
    return (np.full(shape + (kk,), np.inf, np.float32),
            np.zeros(shape + (kk,), np.int32))


def _next_up(d):
    """The least float32 above each non-negative ``d``; +inf stays."""
    up = (d.view(np.int32) + 1).view(np.float32)
    return np.where(np.isinf(d), d, up)


def _seed(q, valid, kk, window):
    """Each row's threshold: just above the kk-th distance among the
    ``window`` points around it (clamped into the cloud), +inf where fewer
    than kk are valid. ``q`` [B, M, 3], ``valid`` [B, M]."""
    b, m = valid.shape
    rows = np.arange(m)
    lo = np.minimum(np.maximum(rows - window // 2, 0), max(m - window, 0))
    D, I = _empty((b, m), kk)
    for w in range(min(window, m)):
        j = lo + w
        d = _sqdist(q, q[:, j])
        _insert(D, I, d, j, valid[:, j] & (d < D[..., -1]))
    return _next_up(D[..., -1])


def _sweep(q, valid, kk, slice_len, window):
    """The sweep's partial lists ``[B, S, M, kk]``: each row's top-kk of
    each slice among the distances below its threshold."""
    b, m = valid.shape
    slices = -(-m // slice_len)
    D, I = _empty((b, slices, m), kk)
    thr = (np.repeat(_seed(q, valid, kk, window)[:, None], slices, axis=1)
           if window > 0 else np.full((b, slices, m), np.inf, np.float32))
    # the staged slices: a masked target and the padding as NaN
    staged = np.full((b, slices * slice_len, 3), np.nan, np.float32)
    staged[:, :m] = np.where(valid[..., None], q, np.float32(np.nan))
    staged = staged.reshape(b, slices, slice_len, 3)
    starts = np.arange(slices) * slice_len
    for t in range(slice_len):
        d = _sqdist(q[:, None], staged[:, :, t][:, :, None])
        take = d < thr
        j = (starts + t)[None, :, None]
        _insert(D, I, d, j, take)
        thr = np.where(take, np.minimum(thr, D[..., -1]), thr)
    return D, I


def _merge(D, I):
    """The merge: the slices' lists, slice by slice and each ascending, by
    strict insertion into ``[B, M, kk]`` (the kernel leaves a list at its
    first refused entry; the entries after it are refused as well)."""
    b, slices, m, kk = D.shape
    OD, OI = _empty((b, m), kk)
    for s in range(slices):
        for c in range(kk):
            d = D[:, s, :, c]
            _insert(OD, OI, d, I[:, s, :, c], d < OD[..., -1])
    return OD, OI


def self_knn_mirror(q, kk: int, mask=None, *,
                    slice_len: Optional[int] = None, window: int = WINDOW
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's ``(idx int32 [..., M, kk], sqdist f32 [..., M, kk])``
    for ``q`` [M, 3] or [B, M, 3] (``mask`` [..., M]), with the card's plan
    of slices unless ``slice_len`` is given (one slice: no merge), seeded
    by ``window`` points around each row (0: no seed)."""
    q = np.asarray(q, np.float32)
    lead = q.shape[:-2]
    qb = q.reshape((-1,) + q.shape[-2:])
    b, m = qb.shape[:2]
    valid = (np.ones((b, m), bool) if mask is None
             else np.asarray(mask).reshape(b, m).astype(bool))
    if m == 0:
        return (np.zeros(lead + (0, kk), np.int32),
                np.zeros(lead + (0, kk), np.float32))
    if slice_len is None:
        slice_len = plan_knn(b, m, kk, H100_SMS)[1]
    with np.errstate(invalid="ignore", over="ignore"):
        D, I = _sweep(qb, valid, kk, slice_len, window)
    if D.shape[1] > 1:
        D, I = _merge(D, I)
    else:
        D, I = D[:, 0], I[:, 0]
    return I.reshape(lead + (m, kk)), D.reshape(lead + (m, kk))
