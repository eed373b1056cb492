"""Kernel svd3 on Hopper: the Kabsch rotation of a batch of 3x3 matrices,
CUDA C++ (``csrc/svd3.cu``).

The port's own kernel: the JAX package computes this SVD in XLA
(``fpcr_tpu/ops/solve.py:84``), so it replaces no ``pallas_call``. It
replaces ``torch.linalg.svd`` on the card, which checks its status on the
host, so that an ICP iteration never waits for the card. This module is its
wrapper: it checks the input, allocates the output with ``torch.empty``,
launches on PyTorch's current stream, raises when a launch is refused, and
counts launches in ``svd3_rotation_cuda.launches``. It takes CUDA tensors
only; the plain version is ``ops.solve.rotation_from_svd_plain``
(``torch.linalg.svd``), and ``ops.solve.rotation_from_svd`` picks between
the two by the device of its input.
"""

from __future__ import annotations

import torch

from .. import _build
from .matching_cuda import _raise_on


def svd3_rotation_cuda(W: torch.Tensor,
                       det_correction: bool = True) -> torch.Tensor:
    """``R = U·Vᵀ`` of each 3x3 ``W`` [..., 3, 3] (float32, contiguous, on a
    CUDA device), with the det(R) = +1 fix of the smallest singular value's
    column when ``det_correction``; one launch for the whole batch.
    ``W = 0`` gives the identity, a non-finite ``W`` a NaN ``R``."""
    if not isinstance(W, torch.Tensor) or W.device.type != "cuda":
        raise ValueError("svd3_rotation_cuda takes a CUDA tensor")
    if W.dtype != torch.float32:
        raise ValueError(f"W must be float32, got {W.dtype}")
    if W.ndim < 2 or tuple(W.shape[-2:]) != (3, 3):
        raise ValueError(f"W must be [..., 3, 3], got {tuple(W.shape)}")
    if not W.is_contiguous():
        raise ValueError("W must be contiguous")
    batch = W.numel() // 9
    if batch >= 2 ** 31:
        raise ValueError(f"{batch} matrices exceed an int32 batch")
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
