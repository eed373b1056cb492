"""Kernel K4 on Hopper: the fused direct7 NDT moments, CUDA C++.

The kernel (``csrc/ndt.cu``) replaces the TPU kernel
``fpcr_tpu/ops/ndt_pallas.py::ndt_fused_moments``. This module is its
wrapper: it checks the inputs, computes the band geometry with torch on the
device (``ops.ndt.fused_geometry``: query cells, probe keys, ``searchsorted``,
bases, anchors), allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream, raises when a launch is refused, and counts
launches in ``ndt_fused_moments_cuda.launches``. It takes CUDA tensors only;
the plain version is ``ops.ndt.ndt_fused_moments_plain``, and
``ops.ndt.ndt_fused_moments`` picks between the two by the device of its
input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .matching_cuda import _check_points, _raise_on
from .ndt import (FUSED_ALIGN, FusedNDTTables, NDTGrid, _check_neighborhood,
                  fused_geometry)


def _check_table(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                         f"{x.dtype} {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ndt_fused_moments_cuda(points: torch.Tensor, grid: NDTGrid,
                           tables: FusedNDTTables, *, voxel_size: float,
                           d1: float, d2: float,
                           neighborhood: str = "direct7", chunk: int = 512,
                           window: int = 256,
                           source_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query direct7 GN moments, computed by kernel K4.

    ``points`` f32[n,3] contiguous on a CUDA device, voxel-key-sorted;
    ``grid`` and ``tables`` (:func:`ops.ndt.prepare_fused_tables`) on the
    same device; ``chunk`` a multiple of 128. Returns ``(rows f32[n,16],
    xprime f32[n,3])`` as ``ops.ndt.ndt_fused_moments_plain`` defines them.
    """
    _check_points("points", points, getattr(points, "device", None))
    _check_neighborhood(neighborhood)
    if chunk < FUSED_ALIGN or chunk % FUSED_ALIGN or window < 0:
        raise ValueError(f"need chunk a positive multiple of {FUSED_ALIGN} "
                         f"and window >= 0, got {chunk}, {window}")
    dev = points.device
    m = tables.keys.shape[0]
    _check_table("tables.keys", tables.keys, torch.int32, (m,), dev)
    _check_table("tables.tab", tables.tab, torch.float32, (m, 16), dev)
    _check_table("grid.lo", grid.lo, torch.float32, (3,), dev)

    n = points.shape[0]
    rows = torch.empty((n, 16), dtype=torch.float32, device=dev)
    xprime = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return rows, xprime
    geo = fused_geometry(points, grid, voxel_size, chunk, window, source_mask)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fpcr_ndt_moments(
            geo.points.data_ptr(), grid.lo.data_ptr(), geo.cells.data_ptr(),
            geo.bases.data_ptr(), geo.anchors.data_ptr(), geo.bases.shape[0],
            tables.keys.data_ptr(), tables.tab.data_ptr(), n, m, chunk,
            geo.band, int(neighborhood == "direct7"), abs(d1) * d2, d2,
            rows.data_ptr(), xprime.data_ptr(), stream)
        _raise_on(lib, rc, "ndt_moments")
        ndt_fused_moments_cuda.launches += 1
    return rows, xprime


_build.counted(ndt_fused_moments_cuda)  # kernel launches made by this wrapper
