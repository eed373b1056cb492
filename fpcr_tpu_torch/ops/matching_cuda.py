"""Kernel K1 on Hopper: exact brute-force nearest neighbour, CUDA C++.

The kernel (``csrc/matching.cu``) replaces the TPU kernel
``fpcr_tpu/ops/matching_pallas.py::nn_argmin_pallas``. This module is its
wrapper: it checks the inputs, plans the launch, allocates the outputs and
scratch with ``torch.empty``, launches on PyTorch's current stream, raises
when a launch is refused, and counts launches in
``nn_argmin_cuda.launches``. It takes CUDA tensors only; the plain version
is ``ops.matching.nn_argmin_plain``, and ``ops.matching.nn_argmin`` picks
between the two by the device of its input.
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
        raise ValueError(f"nn_argmin_cuda takes CUDA tensors; {name} lies on "
                         f"{x.device}")
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
    _check_points("p", p, getattr(p, "device", None))
    _check_points("q", q, p.device)
    n, m = p.shape[0], q.shape[0]
    if m == 0:
        raise ValueError("nn_argmin_cuda needs at least one target")
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

    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    slices, slice_len = plan_slices(n, m, lib.fpcr_nn_rows_per_block(), sms)
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
