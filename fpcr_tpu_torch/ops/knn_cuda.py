"""The self-kNN kernel on Hopper: the ``kk`` nearest valid points of every
point of a cloud, CUDA C++ (``csrc/knn.cu``), for the normals prepass.

The port's own kernel: the JAX package selects the neighbours with
``lax.top_k`` (``fpcr_tpu/ops/normals.py:44``), so it replaces no
``pallas_call``. It replaces, on the card, the plain stream of distance
tiles and ``torch.topk`` (``ops/normals.py::knn`` with ``exact=True``: 64
tile steps and 3,488 launches at 16,384 points), which it equals bit for
bit: a sweep over target slices and a merge, two launches a call (one
where the targets fit one slice). It is bound by the CUDA cores' issue of
about 10 instructions a pair over M² pairs (``csrc/knn.cu``).

This module is its wrapper: it checks the inputs, plans the slices
(:func:`plan_knn`), allocates the outputs and partials with
``torch.empty``, launches on PyTorch's current stream, raises when a
launch is refused, and counts launches in ``self_knn_cuda.launches``. It
takes CUDA tensors only; the plain version is ``ops.normals.knn(q, q, kk,
mask, exact=True)``, and ``ops.normals.estimate_normals`` picks the kernel
by :func:`ops.normals.knn_kernel_route`. The kernel's CPU mirror is
``ops/knn_mirror.py``. On no path: :func:`_self_knn_unseeded` runs the
sweep without its seeded threshold, for timing.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.cloud import round_up
from .matching_cuda import MAX_BATCH, _raise_on, plan_slices

K_MAX = 16  # the largest kk (csrc/knn.cu: kKMax)
MAX_SLICE = 2048  # targets a sweep block holds in shared memory
WINDOW = 32  # the seed's points around a row (csrc/knn.cu)
THREADS = 128  # threads a sweep block


def rows_per_block(kk: int) -> int:
    """Query rows a sweep block holds: four a thread up to kk = 8, two
    above (``csrc/knn.cu``'s ``rows_for``)."""
    return THREADS * (4 if kk <= 8 else 2)


def plan_knn(batch: int, m: int, kk: int,
             sm_count: int) -> Tuple[int, int]:
    """``(slices, slice_len)`` of the sweep over ``batch`` clouds of ``m``
    points: enough slices that the sweep's blocks fill ``sm_count`` SMs,
    each a multiple of 256 targets and at most :data:`MAX_SLICE`. One
    slice means no merge."""
    slices, slice_len = plan_slices(m, m, rows_per_block(kk), sm_count,
                                    batch)
    if slice_len > MAX_SLICE:
        slice_len = round_up(math.ceil(m / math.ceil(m / MAX_SLICE)), 256)
    return math.ceil(m / slice_len), slice_len


def sweep_blocks(batch: int, m: int, kk: int, sm_count: int) -> int:
    """The blocks of the sweep over ``batch`` clouds of ``m`` points."""
    slices, _ = plan_knn(batch, m, kk, sm_count)
    return batch * math.ceil(m / rows_per_block(kk)) * slices


@functools.lru_cache(maxsize=None)
def sm_count(index: Optional[int]) -> int:
    """The SMs of CUDA device ``index``, once the library's constants are
    checked against this module's."""
    lib = _build.load_library()
    if (lib.fpcr_knn_k_max(), lib.fpcr_knn_max_slice(),
            lib.fpcr_knn_rows_per_block(1),
            lib.fpcr_knn_rows_per_block(K_MAX)) != (
            K_MAX, MAX_SLICE, rows_per_block(1), rows_per_block(K_MAX)):
        raise RuntimeError("csrc/knn.cu's constants differ from "
                           "ops/knn_cuda.py's")
    return torch.cuda.get_device_properties(
        torch.device("cuda", index)).multi_processor_count


def _check(q, kk: int, mask, name: str) -> int:
    """The batch of ``q`` (1 for [M, 3]), checked with ``kk`` and
    ``mask``."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor")
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32, got {q.dtype}")
    if q.ndim not in (2, 3) or q.shape[-1] != 3:
        raise ValueError(f"q must be [M, 3] or [B, M, 3], got "
                         f"{tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if 3 * q.shape[-2] >= 2 ** 31:
        raise ValueError("q has too many points for int32 offsets")
    batch = q.shape[0] if q.ndim == 3 else 1
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a launch takes 1 to {MAX_BATCH} clouds "
                         f"(gridDim.z), got {batch}")
    if not 1 <= kk <= K_MAX:
        raise ValueError(f"kk must be 1 to {K_MAX}, got {kk}")
    if mask is not None:
        if mask.device != q.device:
            raise ValueError(f"mask lies on {mask.device}, q on {q.device}")
        if mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
        if mask.shape != q.shape[:-1]:
            raise ValueError(f"mask must be {list(q.shape[:-1])}, got "
                             f"{list(mask.shape)}")
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
    return batch


def _self_knn(fn, q, kk: int, mask, window: int):
    """Plan and launch the sweep, seeded by ``window`` points around each
    row (0: no seed), and the merge past one slice, for the wrapper ``fn``,
    counting its launches on it."""
    batch = _check(q, kk, mask, fn.__name__)
    m = q.shape[-2]
    out_d = torch.empty(q.shape[:-1] + (kk,), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty(q.shape[:-1] + (kk,), dtype=torch.int32,
                        device=q.device)
    if m == 0:
        return out_i, out_d
    slices, slice_len = plan_knn(batch, m, kk, sm_count(q.device.index))
    if slices == 1:
        part_d, part_i = out_d, out_i
    else:
        part_d = torch.empty((batch, slices, m, kk), dtype=torch.float32,
                             device=q.device)
        part_i = torch.empty((batch, slices, m, kk), dtype=torch.int32,
                             device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fpcr_knn_sweep(q.data_ptr(),
                                None if mask is None else mask.data_ptr(),
                                batch, m, kk, slice_len, window,
                                part_d.data_ptr(), part_i.data_ptr(), stream)
        _raise_on(lib, rc, "knn_sweep")
        fn.launches += 1
        if slices > 1:
            rc = lib.fpcr_knn_merge(part_d.data_ptr(), part_i.data_ptr(),
                                    batch, m, kk, slices, out_d.data_ptr(),
                                    out_i.data_ptr(), stream)
            _raise_on(lib, rc, "knn_merge")
            fn.launches += 1
    return out_i, out_d


def self_knn_cuda(q: torch.Tensor, kk: int,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``kk`` (1 to :data:`K_MAX`) nearest valid points of every point
    of ``q`` [M, 3] (or a batch [B, M, 3], masks [B, M]; float32,
    contiguous, on a CUDA device), itself included: ``(idx int32 [..., M,
    kk], sqdist f32 [..., M, kk])``, ascending by the difference form's
    distance, ties to the lower index, ``(0, inf)`` where no valid point
    is left; ``knn(q, q, kk, mask, exact=True)`` bit for bit. Two launches
    (one where the points fit one slice)."""
    return _self_knn(self_knn_cuda, q, kk, mask, WINDOW)


_build.counted(self_knn_cuda)  # kernel launches made by this wrapper


def _self_knn_unseeded(q: torch.Tensor, kk: int,
                       mask: Optional[torch.Tensor] = None):
    """:func:`self_knn_cuda` with the sweep's threshold starting at +inf in
    every slice (no seed), for timing; the same output. On no path."""
    return _self_knn(_self_knn_unseeded, q, kk, mask, 0)


_build.counted(_self_knn_unseeded)
