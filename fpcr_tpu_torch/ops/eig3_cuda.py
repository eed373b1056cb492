"""Kernel eig3 on Hopper: the eigenvalues and eigenvectors of a batch of
symmetric 3x3 matrices, CUDA C++ (``csrc/svd3.cu``, ``eig3_one``, on
svd3's Jacobi rotations).

The port's own kernel: the JAX package takes these eigenvectors from a
closed form (``fpcr_tpu/ops/eigh3.py``), which loses them where two
eigenvalues meet. It replaces ``torch.linalg.eigh`` on the card, which
checks its status on the host, so that the normals prepass never waits for
the card. This module is its wrapper: it checks the input as
``ops/svd3_cuda.py`` does, allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream, raises when a launch is refused, and
counts launches in ``eig3_cuda.launches``. It takes CUDA tensors only; the
plain version is ``ops.eigh3.eig3_plain`` (``torch.linalg.eigh`` in
float32), and ``ops.eigh3.eigh3`` picks between them by the device of its
input. The kernel's CPU mirror is ``ops/eig3_mirror.py``.
"""

from __future__ import annotations

import torch

from .. import _build
from .matching_cuda import _raise_on
from .svd3_cuda import _check


def eig3_cuda(A: torch.Tensor):
    """``(vals [..., 3], vecs [..., 3, 3])`` of each symmetric 3x3 ``A``
    [..., 3, 3] (float32, contiguous, on a CUDA device): the eigenvalues
    ascending and ``vecs[..., :, j]`` the j-th eigenvector, one launch for
    the whole batch. ``A ≈ qI`` (zero included) gives the fixed frame whose
    first column is (1,1,1)/√3; a non-finite ``A`` NaN for both."""
    batch = _check(A, "eig3_cuda")
    vals = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    vecs = torch.empty_like(A)
    if batch == 0:
        return vals, vecs
    lib = _build.load_library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.fpcr_eig3(A.data_ptr(), batch, vals.data_ptr(),
                           vecs.data_ptr(), stream)
        _raise_on(lib, rc, "eig3")
        eig3_cuda.launches += 1
    return vals, vecs


_build.counted(eig3_cuda)  # kernel launches made by this wrapper
