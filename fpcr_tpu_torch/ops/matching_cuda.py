"""Kernels K1, K2 and the min-only sweep on Hopper: brute-force nearest
neighbour, CUDA C++ (``csrc/matching.cu``).

* :func:`nn_argmin_cuda` launches K1, exact NN, which replaces the TPU
  kernel ``fpcr_tpu/ops/matching_pallas.py::nn_argmin_pallas``; plain
  version ``ops.matching.nn_argmin_plain``, dispatcher
  ``ops.matching.nn_argmin``;
* :func:`nn_argmin_packed_cuda` launches K2, the packed (value|index)
  reduction of the same function's mode ``'packed6_idx'``; plain version
  ``ops.matching.nn_argmin_packed_plain``, dispatcher
  ``ops.matching.nn_argmin_packed``;
* :func:`nn_min_only_cuda` launches the min-only sweep of
  ``scripts/exp_packed_reduction.py::make_minonly``; plain version and
  dispatcher in ``bench/packed_reduction.py``.

Each wrapper checks the inputs, plans the launch, allocates the outputs and
scratch with ``torch.empty``, launches on PyTorch's current stream, raises
when a launch is refused, and counts its launches in its own ``.launches``.
They take CUDA tensors only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.cloud import round_up

SLICE_QUANTUM = 256  # a target slice is a multiple of this many targets
BLOCKS_PER_SM = 4  # the launch aims at this many blocks per SM


def plan_slices(n: int, m: int, rows_per_block: int,
                sm_count: int) -> Tuple[int, int]:
    """``(slices, slice_len)``: split the M targets into slices over
    ``blockIdx.y`` so that ``ceil(n / rows_per_block) * slices`` blocks
    fill the card, with every slice a multiple of ``SLICE_QUANTUM`` and
    none empty. One slice means no combine pass."""
    row_blocks = max(1, math.ceil(n / rows_per_block))
    want = math.ceil(BLOCKS_PER_SM * sm_count / row_blocks)
    slices = max(1, min(want, math.ceil(m / SLICE_QUANTUM)))
    slice_len = round_up(math.ceil(m / slices), SLICE_QUANTUM)
    return math.ceil(m / slice_len), slice_len


def _check_points(name: str, x: torch.Tensor, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors; {name} lies "
                         f"on {x.device}")
    if x.device != device:
        raise ValueError(f"{name} lies on {x.device}, p on {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must be [*, 3], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if 3 * x.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for int32 offsets")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fpcr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_inputs(what: str, p, q, q_mask) -> Optional[int]:
    """Check the points and the mask of a brute-force launch; returns the
    mask's pointer (None for no mask)."""
    _check_points("p", p, getattr(p, "device", None))
    _check_points("q", q, p.device)
    m = q.shape[0]
    if m == 0:
        raise ValueError(f"{what} needs at least one target")
    mask_ptr = None
    if q_mask is not None:
        if q_mask.device != p.device:
            raise ValueError(f"q_mask lies on {q_mask.device}, p on "
                             f"{p.device}")
        if q_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"q_mask must be bool or uint8, got "
                             f"{q_mask.dtype}")
        if q_mask.shape != (m,):
            raise ValueError(f"q_mask must be [{m}], got "
                             f"{tuple(q_mask.shape)}")
        if not q_mask.is_contiguous():
            raise ValueError("q_mask must be contiguous")
        mask_ptr = q_mask.data_ptr()
    return mask_ptr


def _plan(p: torch.Tensor, m: int):
    """``(lib, slices, slice_len)`` of a brute-force launch over ``p``."""
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    slices, slice_len = plan_slices(p.shape[0], m,
                                    lib.fpcr_nn_rows_per_block(), sms)
    return lib, slices, slice_len


def nn_argmin_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every source point, the index of its nearest valid target and
    the squared distance, computed by kernel K1 on the card.

    ``p`` f32[N,3] and ``q`` f32[M,3] (M >= 1), contiguous, on one CUDA
    device; ``q_mask`` optional bool/uint8[M]. Returns ``(idx int32[N],
    sqdist f32[N])``: ties go to the lowest index; a row with no valid
    target gets idx 0 and ``inf``.
    """
    mask_ptr = _check_inputs("nn_argmin_cuda", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        if slices == 1:
            rc = lib.fpcr_nn_partial(p.data_ptr(), q.data_ptr(), mask_ptr, n,
                                     m, slice_len, dist.data_ptr(),
                                     idx.data_ptr(), stream)
            _raise_on(lib, rc, "nn_partial")
            nn_argmin_cuda.launches += 1
            return idx, dist
        part_d = torch.empty((slices, n), dtype=torch.float32,
                             device=p.device)
        part_i = torch.empty((slices, n), dtype=torch.int32, device=p.device)
        rc = lib.fpcr_nn_partial(p.data_ptr(), q.data_ptr(), mask_ptr, n, m,
                                 slice_len, part_d.data_ptr(),
                                 part_i.data_ptr(), stream)
        _raise_on(lib, rc, "nn_partial")
        nn_argmin_cuda.launches += 1
        rc = lib.fpcr_nn_combine(part_d.data_ptr(), part_i.data_ptr(), n,
                                 slices, dist.data_ptr(), idx.data_ptr(),
                                 stream)
        _raise_on(lib, rc, "nn_combine")
        nn_argmin_cuda.launches += 1
    return idx, dist


nn_argmin_cuda.launches = 0  # kernel launches made by this wrapper


def nn_argmin_packed_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    idx_bits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid target by the packed (value|index) reduction, computed
    by kernel K2 on the card: the int32 min over j of ``(bits(d_ij) &
    ~(2^idx_bits - 1)) | j``, then the exact distance to the pick.

    Inputs as :func:`nn_argmin_cuda`, and ``idx_bits`` in [1, 23] with
    ``M <= 2^idx_bits``. Returns ``(idx int32[N], sqdist f32[N])``: ties
    within a bucket go to the lowest index; the distance is the exact one
    of the selected target; a row with no valid target gets idx 0 and
    ``inf``. Two launches: the sweep and the epilogue.
    """
    mask_ptr = _check_inputs("nn_argmin_packed_cuda", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    check_idx_bits(m, idx_bits)
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        keys = torch.empty((slices, n), dtype=torch.int32, device=p.device)
        rc = lib.fpcr_nn_packed_partial(p.data_ptr(), q.data_ptr(), mask_ptr,
                                        n, m, slice_len, idx_bits,
                                        keys.data_ptr(), stream)
        _raise_on(lib, rc, "nn_packed_partial")
        nn_argmin_packed_cuda.launches += 1
        rc = lib.fpcr_nn_packed_epilogue(p.data_ptr(), q.data_ptr(),
                                         keys.data_ptr(), n, m, slices,
                                         idx_bits, dist.data_ptr(),
                                         idx.data_ptr(), stream)
        _raise_on(lib, rc, "nn_packed_epilogue")
        nn_argmin_packed_cuda.launches += 1
    return idx, dist


nn_argmin_packed_cuda.launches = 0  # kernel launches made by this wrapper


def check_idx_bits(m: int, idx_bits: int) -> None:
    """A packed key holds the target index in its low ``idx_bits`` bits and
    keeps at least the distance's exponent and 0 mantissa bits above."""
    if not 1 <= idx_bits <= 23:
        raise ValueError(f"idx_bits must lie in [1, 23], got {idx_bits}")
    if m > (1 << idx_bits):
        raise ValueError(f"{m} targets do not fit in {idx_bits} index bits")


def nn_min_only_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The least squared distance f32[N] of every source point to a valid
    target (``inf`` where none is valid), by the min-only sweep on the
    card. Inputs as :func:`nn_argmin_cuda`."""
    mask_ptr = _check_inputs("nn_min_only_cuda", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return dist
    lib, slices, slice_len = _plan(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        part = dist if slices == 1 else torch.empty(
            (slices, n), dtype=torch.float32, device=p.device)
        rc = lib.fpcr_nn_min_partial(p.data_ptr(), q.data_ptr(), mask_ptr, n,
                                     m, slice_len, part.data_ptr(), stream)
        _raise_on(lib, rc, "nn_min_partial")
        nn_min_only_cuda.launches += 1
        if slices > 1:
            rc = lib.fpcr_nn_min_combine(part.data_ptr(), n, slices,
                                         dist.data_ptr(), stream)
            _raise_on(lib, rc, "nn_min_combine")
            nn_min_only_cuda.launches += 1
    return dist


nn_min_only_cuda.launches = 0  # kernel launches made by this wrapper
