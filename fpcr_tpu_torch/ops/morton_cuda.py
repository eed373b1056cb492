"""Kernels K3 and K3p on Hopper: Morton band nearest neighbour, CUDA C++.

The kernels (``csrc/morton.cu``) replace the TPU kernel
``fpcr_tpu/ops/morton_pallas.py::morton_nn_pallas``: K3 its modes
``'highest'`` and ``'packed6'``, K3p its packed (value|index) reduction,
mode ``'packed6_idx'``. This module holds their wrappers,
``morton_nn_cuda`` (K3) and ``morton_nn_packed_cuda`` (K3p), which share
one launcher: it checks the inputs, computes the band bases with torch on
the device (``ops.morton.band_bases``: probe codes, ``searchsorted``, clip,
align), allocates the outputs with ``torch.empty``, launches on PyTorch's
current stream and raises when a launch is refused. Each wrapper counts
its launches in its own ``.launches``. They take CUDA tensors only; the
plain versions are ``ops.morton.morton_nn_band_plain`` and
``morton_nn_band_packed_plain``, and ``ops.morton.morton_nn_band`` picks by
the device of its input and its ``mode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .matching_cuda import _check_points, _raise_on
from .morton import MortonTable, band_bases, band_idx_bits


def _launch(p: torch.Tensor, table: MortonTable,
            extra: Optional[torch.Tensor], chunk: int, window: int,
            packed: bool):
    """Check the inputs, compute the band bases and launch K3 or, with
    ``packed``, K3p: ``(the four outputs, whether a kernel was launched)``
    (nothing is launched for an empty ``p``). The public wrappers count."""
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
        return (matched, dist, idx, out_e), False
    band, bases = band_bases(p, table, chunk, window)
    lib = _build.load_library()
    args = [p.data_ptr(), n, q.data_ptr(), m, valid_count.data_ptr(),
            extra_ptr, bases.data_ptr(), bases.shape[0], chunk, band]
    outs = [matched.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            None if out_e is None else out_e.data_ptr()]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        if packed:
            rc = lib.fpcr_morton_nn_packed(*args, band_idx_bits(band), *outs,
                                           stream)
            _raise_on(lib, rc, "morton_nn_packed")
        else:
            rc = lib.fpcr_morton_nn(*args, *outs, stream)
            _raise_on(lib, rc, "morton_nn")
    return (matched, dist, idx, out_e), True


def morton_nn_cuda(p: torch.Tensor, table: MortonTable,
                   extra: Optional[torch.Tensor] = None, chunk: int = 256,
                   window: int = 256):
    """Kernel K3: band NN of Morton-sorted source chunks.

    ``p`` f32[N,3] contiguous on a CUDA device, rows in source-coherent
    order; ``table`` on the same device (``valid_count`` an int32 scalar
    tensor); ``extra`` optional f32[M,3] in table order. Returns
    ``(matched f32[N,3], sqdist f32[N], idx_sorted int32[N], matched_extra
    f32[N,3] or None)``: ties go to the first band row; matched and extra
    are the table rows at ``idx_sorted``; a row whose band holds no valid
    target gets idx 0 and ``inf``.
    """
    out, launched = _launch(p, table, extra, chunk, window, packed=False)
    if launched:
        morton_nn_cuda.launches += 1
    return out


morton_nn_cuda.launches = 0  # K3 launches made by this wrapper


def morton_nn_packed_cuda(p: torch.Tensor, table: MortonTable,
                          extra: Optional[torch.Tensor] = None,
                          chunk: int = 256, window: int = 256):
    """Kernel K3p: :func:`morton_nn_cuda`'s band NN and outputs, picked by
    the least key ``(bits(d) & ~(2^b - 1)) | band_row`` (``b =
    bit_length(band - 1)``), so ties within a bucket go to the first band
    row; the returned distance is the exact one of the pick."""
    out, launched = _launch(p, table, extra, chunk, window, packed=True)
    if launched:
        morton_nn_packed_cuda.launches += 1
    return out


morton_nn_packed_cuda.launches = 0  # K3p launches made by this wrapper
