"""Kernel svd3 on Hopper: the Kabsch rotation of a batch of 3x3 matrices,
and Umeyama's rotation and scale numerator, CUDA C++ (``csrc/svd3.cu``).

The port's own kernel: the JAX package computes this SVD in XLA
(``fpcr_tpu/ops/solve.py:84``), so it replaces no ``pallas_call``. It
replaces ``torch.linalg.svd`` on the card, which checks its status on the
host, so that an ICP iteration never waits for the card. This module is its
wrapper: it checks the input, allocates the output with ``torch.empty``,
launches on PyTorch's current stream, raises when a launch is refused, and
counts launches in ``svd3_rotation_cuda.launches`` (Umeyama's form in
``svd3_umeyama_cuda.launches``). It takes CUDA tensors only; the plain
versions are ``ops.solve.rotation_from_svd_plain`` and
``umeyama_from_svd_plain`` (``torch.linalg.svd``), and
``ops.solve.rotation_from_svd`` and ``umeyama_from_svd`` pick between the
kernel and the plain version by the device of their input. The kernel's
CPU mirror is ``ops/svd3_mirror.py``.

On no path: :func:`_svd3_rotation_fixed` and :func:`_svd3_umeyama_fixed`
launch the first design (8 float64 sweeps whatever the input), the
yardstick that the kernel is timed against; each counts its own launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .matching_cuda import _raise_on


def _check(W: torch.Tensor, name: str) -> int:
    """The batch of ``W`` [..., 3, 3], checked."""
    if not isinstance(W, torch.Tensor) or W.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor")
    if W.dtype != torch.float32:
        raise ValueError(f"W must be float32, got {W.dtype}")
    if W.ndim < 2 or tuple(W.shape[-2:]) != (3, 3):
        raise ValueError(f"W must be [..., 3, 3], got {tuple(W.shape)}")
    if not W.is_contiguous():
        raise ValueError("W must be contiguous")
    batch = W.numel() // 9
    if batch >= 2 ** 31:
        raise ValueError(f"{batch} matrices exceed an int32 batch")
    return batch


def svd3_rotation_cuda(W: torch.Tensor,
                       det_correction: bool = True) -> torch.Tensor:
    """``R = U·Vᵀ`` of each 3x3 ``W`` [..., 3, 3] (float32, contiguous, on a
    CUDA device), with the det(R) = +1 fix of the smallest singular value's
    column when ``det_correction``; one launch for the whole batch.
    ``W = 0`` gives the identity, a non-finite ``W`` a NaN ``R``."""
    batch = _check(W, "svd3_rotation_cuda")
    out = torch.empty_like(W)
    if batch == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fpcr_svd3_rotation(W.data_ptr(), batch, int(det_correction),
                                    out.data_ptr(), stream)
        _raise_on(lib, rc, "svd3_rotation")
        svd3_rotation_cuda.launches += 1
    return out


_build.counted(svd3_rotation_cuda)  # kernel launches made by this wrapper


def svd3_umeyama_cuda(W: torch.Tensor):
    """Umeyama's form of each 3x3 ``W`` [..., 3, 3] (float32, contiguous, on
    a CUDA device): ``(R [..., 3, 3], trace [...])`` with ``R =
    U·diag(1, 1, d)·Vᵀ``, ``trace = σ1 + σ2 + d·σ3`` and ``d = sign(det U ·
    det Vᵀ)`` (1 where σ3 is at the kernel's rank tolerance); one launch
    for the whole batch. ``W = 0`` gives the identity and 0, a non-finite
    ``W`` NaN for both."""
    batch = _check(W, "svd3_umeyama_cuda")
    out = torch.empty_like(W)
    trace = torch.empty(W.shape[:-2], dtype=W.dtype, device=W.device)
    if batch == 0:
        return out, trace
    lib = _build.load_library()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fpcr_svd3_umeyama(W.data_ptr(), batch, out.data_ptr(),
                                   trace.data_ptr(), stream)
        _raise_on(lib, rc, "svd3_umeyama")
        svd3_umeyama_cuda.launches += 1
    return out, trace


_build.counted(svd3_umeyama_cuda)  # kernel launches made by this wrapper


def _svd3_rotation_fixed(W: torch.Tensor,
                         det_correction: bool = True) -> torch.Tensor:
    """:func:`svd3_rotation_cuda` by the yardstick, the first design (8
    float64 sweeps whatever the input); on no path."""
    batch = _check(W, "_svd3_rotation_fixed")
    out = torch.empty_like(W)
    if batch == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fpcr_svd3_fixed_rotation(W.data_ptr(), batch,
                                          int(det_correction),
                                          out.data_ptr(), stream)
        _raise_on(lib, rc, "svd3_fixed_rotation")
        _svd3_rotation_fixed.launches += 1
    return out


_build.counted(_svd3_rotation_fixed)


def _svd3_umeyama_fixed(W: torch.Tensor):
    """:func:`svd3_umeyama_cuda` by the yardstick; on no path."""
    batch = _check(W, "_svd3_umeyama_fixed")
    out = torch.empty_like(W)
    trace = torch.empty(W.shape[:-2], dtype=W.dtype, device=W.device)
    if batch == 0:
        return out, trace
    lib = _build.load_library()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fpcr_svd3_fixed_umeyama(W.data_ptr(), batch, out.data_ptr(),
                                         trace.data_ptr(), stream)
        _raise_on(lib, rc, "svd3_fixed_umeyama")
        _svd3_umeyama_fixed.launches += 1
    return out, trace


_build.counted(_svd3_umeyama_fixed)
