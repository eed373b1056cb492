"""Kernel K3 on Hopper: Morton band nearest neighbour, CUDA C++.

The kernel (``csrc/morton.cu``) replaces the TPU kernel
``fpcr_tpu/ops/morton_pallas.py::morton_nn_pallas``. This module is its
wrapper: it checks the inputs, computes the band bases with torch on the
device (``ops.morton.band_bases``: probe codes, ``searchsorted``, clip,
align), allocates the outputs with ``torch.empty``, launches on PyTorch's
current stream, raises when a launch is refused, and counts launches in
``morton_nn_cuda.launches``. It takes CUDA tensors only; the plain version
is ``ops.morton.morton_nn_band_plain``, and ``ops.morton.morton_nn_band``
picks between the two by the device of its input.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .matching_cuda import _check_points, _raise_on
from .morton import MortonTable, band_bases


def morton_nn_cuda(p: torch.Tensor, table: MortonTable,
                   extra: Optional[torch.Tensor] = None, chunk: int = 256,
                   window: int = 256):
    """Band NN of Morton-sorted source chunks, computed by kernel K3.

    ``p`` f32[N,3] contiguous on a CUDA device, rows in source-coherent
    order; ``table`` on the same device (``valid_count`` an int32 scalar
    tensor); ``extra`` optional f32[M,3] in table order. Returns
    ``(matched f32[N,3], sqdist f32[N], idx_sorted int32[N], matched_extra
    f32[N,3] or None)``: ties go to the first band row; matched and extra
    are the table rows at ``idx_sorted``; a row whose band holds no valid
    target gets idx 0 and ``inf``.
    """
    _check_points("p", p, getattr(p, "device", None))
    q = table.points_sorted
    _check_points("table.points_sorted", q, p.device)
    n, m = p.shape[0], q.shape[0]
    if m == 0:
        raise ValueError("morton_nn_cuda needs at least one target")
    if chunk < 1 or window < 0:
        raise ValueError(f"need chunk >= 1 and window >= 0, got {chunk}, "
                         f"{window}")
    valid_count = table.valid_count
    if (not isinstance(valid_count, torch.Tensor)
            or valid_count.device != p.device or valid_count.numel() != 1
            or valid_count.dtype != torch.int32):
        raise ValueError("table.valid_count must be an int32 scalar tensor "
                         f"on {p.device}")
    extra_ptr = None
    if extra is not None:
        _check_points("extra", extra, p.device)
        if extra.shape[0] != m:
            raise ValueError(f"extra must be [{m}, 3], got "
                             f"{tuple(extra.shape)}")
        extra_ptr = extra.data_ptr()

    matched = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    out_e = None if extra is None else torch.empty_like(matched)
    if n == 0:
        return matched, dist, idx, out_e
    band, bases = band_bases(p, table, chunk, window)
    lib = _build.load_library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.fpcr_morton_nn(
            p.data_ptr(), n, q.data_ptr(), m, valid_count.data_ptr(),
            extra_ptr, bases.data_ptr(), bases.shape[0], chunk, band,
            matched.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            None if out_e is None else out_e.data_ptr(), stream)
        _raise_on(lib, rc, "morton_nn")
        morton_nn_cuda.launches += 1
    return matched, dist, idx, out_e


morton_nn_cuda.launches = 0  # kernel launches made by this wrapper
