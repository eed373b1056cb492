"""Kernels K3 and K3p on Hopper: Morton band nearest neighbour, CUDA C++.

The kernels (``csrc/morton.cu``) replace the TPU kernel
``fpcr_tpu/ops/morton_pallas.py::morton_nn_pallas``: K3 its modes
``'highest'`` and ``'packed6'``, K3p its packed (value|index) reduction,
mode ``'packed6_idx'``. Each block computes its chunk's band base itself
(the probe row's Morton code, a lower-bound search of ``codes_sorted``,
clip, align: ``ops.morton.band_bases``, whose scalar mirror is
``ops.morton.prologue_bases``) and skips the band's 32-row sub-tiles that
cannot hold a row's pick. This module holds their wrappers,
``morton_nn_cuda`` (K3) and ``morton_nn_packed_cuda`` (K3p), which share
one launcher: it checks the inputs, allocates the outputs with
``torch.empty``, launches once on PyTorch's current stream and raises when
a launch is refused. Each wrapper counts its launches in its own
``.launches``. They take CUDA tensors only; the plain versions are
``ops.morton.morton_nn_band_plain`` and ``morton_nn_band_packed_plain``,
and ``ops.morton.morton_nn_band`` picks by the device of its input and its
``mode``.

Both take a batch as well, the JAX package's ``vmap`` over its band
kernel: ``p`` [B, N, 3] against a stacked table (``MortonTable`` fields
with a leading B, ``ops.morton.build_morton_table`` of ``[B, M, 3]``
targets) and ``extra`` [B, M, 3] give ``[B, N, ...]`` outputs in one launch
for the whole batch, element ``e`` on ``blockIdx.z`` with its own band bases
and culling, each element's outputs bit for bit those of its own
unbatched call. At most ``MAX_BATCH`` elements; more raises, the batch is
never split.

Two private keywords serve the checks on the card: ``_cull=False`` runs
the same kernel with culling compiled out, and ``_stats``, a dict, receives
each chunk's band base (``'bases'``) and each block's (32-row group,
sub-tile) visits (``'visits'``) as int32 tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from .matching_cuda import MAX_BATCH, _check_points, _raise_on
from .morton import MortonTable, band_idx_bits, band_rows

BAND_SUB = 32  # rows of a band sub-tile and of a source group (kSub)
BAND_TILE = 1024  # band rows staged a step (kTile)


def band_visit_totals(n: int, chunk: int, band: int) -> Tuple[int, int]:
    """``(visits, seeds)``: the (group, sub-tile) visits of an unculled
    call, and the seed sub-tiles a culled call scans besides, for ``n``
    source rows. Groups are 32 consecutive rows of a chunk; each tile of
    ``BAND_TILE`` rows takes one seed a group."""
    full, tail = divmod(n, chunk)
    groups = full * math.ceil(chunk / BAND_SUB) + math.ceil(tail / BAND_SUB)
    return (groups * math.ceil(band / BAND_SUB),
            groups * math.ceil(band / BAND_TILE))


def _check_table(table: MortonTable, device, lead: tuple) -> None:
    """The table's fields on ``device``, contiguous, with the leading
    batch axes ``lead`` (``()`` unbatched, ``(B,)`` for a batch)."""
    m = table.points_sorted.shape[-2]
    for name, t, dtype, shape in (
            ("valid_count", table.valid_count, torch.int32, lead),
            ("codes_sorted", table.codes_sorted, torch.int32, lead + (m,)),
            ("lo", table.lo, torch.float32, lead + (3,)),
            ("inv_extent", table.inv_extent, torch.float32, lead + (3,))):
        if (not isinstance(t, torch.Tensor) or t.device != device
                or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            kind = "scalar" if not shape else list(shape)
            raise ValueError(f"table.{name} must be a contiguous "
                             f"{str(dtype)[6:]} {kind} tensor on {device}")


def _launch(p: torch.Tensor, table: MortonTable,
            extra: Optional[torch.Tensor], chunk: int, window: int,
            packed: bool, cull: bool, stats: Optional[dict]):
    """Check the inputs and launch K3 or, with ``packed``, K3p, over one
    cloud ``p`` [N, 3] or a batch [B, N, 3] (one launch, the element on
    ``blockIdx.z``): ``(the four outputs, whether a kernel was launched)``
    (nothing is launched for an empty ``p``). The public wrappers count."""
    ndim = 3 if getattr(p, "ndim", 2) == 3 else 2
    _check_points("p", p, getattr(p, "device", None), ndim)
    q = table.points_sorted
    _check_points("table.points_sorted", q, p.device, ndim)
    lead = tuple(p.shape[:-2])
    batch = p.shape[0] if ndim == 3 else 1
    n, m = p.shape[-2], q.shape[-2]
    if ndim == 3:
        if q.shape[0] != batch:
            raise ValueError(f"p holds {batch} batch elements, the table "
                             f"{q.shape[0]}")
        if not 1 <= batch <= MAX_BATCH:
            raise ValueError(f"a batched launch takes 1 to {MAX_BATCH} "
                             f"elements (gridDim.z), got {batch}")
    if m == 0:
        raise ValueError("morton_nn_cuda needs at least one target")
    if chunk < 1 or window < 0:
        raise ValueError(f"need chunk >= 1 and window >= 0, got {chunk}, "
                         f"{window}")
    _check_table(table, p.device, lead)
    extra_ptr = None
    if extra is not None:
        _check_points("extra", extra, p.device, ndim)
        if tuple(extra.shape) != tuple(q.shape):
            raise ValueError(f"extra must be {list(q.shape)}, got "
                             f"{list(extra.shape)}")
        extra_ptr = extra.data_ptr()

    matched = torch.empty(lead + (n, 3), dtype=torch.float32,
                          device=p.device)
    dist = torch.empty(lead + (n,), dtype=torch.float32, device=p.device)
    idx = torch.empty(lead + (n,), dtype=torch.int32, device=p.device)
    out_e = None if extra is None else torch.empty_like(matched)
    if n == 0:
        return (matched, dist, idx, out_e), False
    band = band_rows(chunk, window)
    bases = visits = None
    if stats is not None:
        chunks = math.ceil(n / chunk)
        bases = torch.empty(lead + (chunks,), dtype=torch.int32,
                            device=p.device)
        visits = torch.empty(lead + (chunks,), dtype=torch.int32,
                             device=p.device)
        stats.update(bases=bases, visits=visits, band=band)
    lib = _build.load_library()
    fn = {(False, True): lib.fpcr_morton_nn,
          (True, True): lib.fpcr_morton_nn_packed,
          (False, False): lib.fpcr_morton_nn_unculled,
          (True, False): lib.fpcr_morton_nn_packed_unculled}[packed, cull]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), batch, n, q.data_ptr(), m,
                table.valid_count.data_ptr(), extra_ptr,
                table.codes_sorted.data_ptr(), table.lo.data_ptr(),
                table.inv_extent.data_ptr(), chunk, band,
                band_idx_bits(band) if packed else 0, matched.data_ptr(),
                dist.data_ptr(), idx.data_ptr(), ptr(out_e), ptr(bases),
                ptr(visits), stream)
    _raise_on(lib, rc, "morton_nn_packed" if packed else "morton_nn")
    return (matched, dist, idx, out_e), True


def morton_nn_cuda(p: torch.Tensor, table: MortonTable,
                   extra: Optional[torch.Tensor] = None, chunk: int = 256,
                   window: int = 256, *, _cull: bool = True,
                   _stats: Optional[dict] = None):
    """Kernel K3: band NN of Morton-sorted source chunks.

    ``p`` f32[N,3] contiguous on a CUDA device, rows in source-coherent
    order; ``table`` on the same device (``valid_count`` an int32 scalar
    tensor, ``codes_sorted`` int32[M], ``lo`` and ``inv_extent`` f32[3]);
    ``extra`` optional f32[M,3] in table order. Returns ``(matched
    f32[N,3], sqdist f32[N], idx_sorted int32[N], matched_extra f32[N,3] or
    None)``: ties go to the first band row; matched and extra are the table
    rows at ``idx_sorted``; a row whose band holds no valid target gets idx
    0 and ``inf``. A batch ``p`` f32[B,N,3] with a stacked table (fields
    [B, ...], ``valid_count`` int32[B]) and ``extra`` f32[B,M,3] gives
    ``[B, N, ...]`` outputs in one launch, each element's bits those of its
    own call.
    """
    out, launched = _launch(p, table, extra, chunk, window, False, _cull,
                            _stats)
    if launched:
        morton_nn_cuda.launches += 1
    return out


_build.counted(morton_nn_cuda)  # K3 launches made by this wrapper


def morton_nn_packed_cuda(p: torch.Tensor, table: MortonTable,
                          extra: Optional[torch.Tensor] = None,
                          chunk: int = 256, window: int = 256, *,
                          _cull: bool = True, _stats: Optional[dict] = None):
    """Kernel K3p: :func:`morton_nn_cuda`'s band NN and outputs, picked by
    the least key ``(bits(d) & ~(2^b - 1)) | band_row`` (``b =
    bit_length(band - 1)``), so ties within a bucket go to the first band
    row; the returned distance is the exact one of the pick."""
    out, launched = _launch(p, table, extra, chunk, window, True, _cull,
                            _stats)
    if launched:
        morton_nn_packed_cuda.launches += 1
    return out


_build.counted(morton_nn_packed_cuda)  # K3p launches made by this wrapper
