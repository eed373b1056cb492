"""Batched symmetric 3x3 eigendecomposition on the device.

:func:`eigh3` is the one the port computes with: kernel eig3 on the card
(``ops/eig3_cuda.py``, Jacobi rotations to float64, no host read), and
``torch.linalg.eigh`` in float32 on the CPU (:func:`eig3_plain`, LAPACK's
``ssyev`` as the reference's own programs call it), with the same guards:

  * A ≈ qI (``|A − qI| <= ISO_TOL·|A|`` in Frobenius norms, q = tr A / 3,
    the zero matrix included): the fixed frame :data:`ISO_FRAME`, whose
    first column is the JAX package's fallback normal (1,1,1)/√3;
  * a non-finite A: NaN eigenvalues and eigenvectors.

:func:`smallest_eigenvector` (the normals' PCA direction) and NDT's voxel
frames take it. They depart from ``fpcr_tpu/ops/eigh3.py``'s
closed form where two eigenvalues nearly meet, the usual case of a point on
a 16-beam scan, whose nearest neighbours lie nearly on a line: there the
closed form's eigenvectors are off by up to ~1 rad and these hold float64's
to a few float32 epsilons·λ2 / (λ1 − λ0).

The closed form is kept for tests only, the JAX-parity tests that call it
(no function of the port does):
:func:`eigvals3` (trigonometric eigenvalues, Smith's algorithm) and
:func:`_unit_eigenvector` (the largest-norm cross product of the rows of
A − λI, below ``eps`` the fallback direction).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_FALLBACK = (1.0 / math.sqrt(3.0),) * 3


def eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``[..., 3, 3]`` matrices, ascending
    ``[..., 3]``."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)

    safe_p = torch.where(p > 0.0, p, torch.ones_like(p))
    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    det_b = (b00 * (b11 * b22 - b12 * b12)
             - b01 * (b01 * b22 - b12 * b02)
             + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    two_p = 2.0 * p
    lam_max = q + two_p * torch.cos(phi)
    lam_min = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def _unit_eigenvector(A: torch.Tensor, lam: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Null direction of (A - lam I) from the largest-norm cross product of
    its rows, branch-free and batched."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)  # [..., 3]
    best = torch.argmax(norms, dim=-1)  # first maximum, as jnp.argmax
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    good = n[..., 0] > eps
    v_unit = v / torch.where(n > 0, n, torch.ones_like(n))
    # a fill on the device: torch.tensor would copy from the host and
    # synchronise
    fb = torch.full((3,), _FALLBACK[0], dtype=A.dtype, device=A.device)
    return torch.where(good[..., None], v_unit, fb)


# A ≈ qI where |A − qI| <= ISO_TOL·|A| (csrc/svd3.cu: kIsoTol2, its
# square): then λ2 − λ0 <= 1.3 float32 epsilons·max |λ|, where a float32
# input does not resolve the smallest eigenvector's direction. Decided on
# the input in float64, so that the kernel and the plain path agree
ISO_TOL = 2.0 ** -22
# the eigenvectors of A ≈ qI, as columns: (1,1,1)/√3, (2,−1,−1)/√6 and
# (0,1,−1)/√2, a right-handed frame
ISO_FRAME = ((1.0 / math.sqrt(3.0), 2.0 / math.sqrt(6.0), 0.0),
             (1.0 / math.sqrt(3.0), -1.0 / math.sqrt(6.0),
              1.0 / math.sqrt(2.0)),
             (1.0 / math.sqrt(3.0), -1.0 / math.sqrt(6.0),
              -1.0 / math.sqrt(2.0)))


def eig3_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel eig3's plain version, on any device: ``torch.linalg.eigh`` of
    the float32 ``A`` [..., 3, 3] with the kernel's guards. On a CUDA
    tensor it waits for the card."""
    A = A.to(torch.float32)
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    A = torch.where(finite[..., None, None], A, eye)
    vals, vecs = torch.linalg.eigh(A)
    a64 = A.double()
    q = a64.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    dev = a64 - q[..., None, None] * eye.double()
    iso = ((dev * dev).sum((-2, -1))
           <= ISO_TOL * ISO_TOL * (a64 * a64).sum((-2, -1)))
    frame = torch.tensor(ISO_FRAME, dtype=A.dtype, device=A.device)
    vecs = torch.where(iso[..., None, None], frame, vecs)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(finite[..., None], vals, nan),
            torch.where(finite[..., None, None], vecs, nan))


def smallest_eigenvector(A: torch.Tensor, eps: float = 1e-20
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvector, eigenvalue) of the smallest eigenvalue of symmetric
    ``[..., 3, 3]`` batches, by :func:`eigh3`: the PCA surface-normal
    direction, (1,1,1)/√3 where A ≈ qI. ``eps`` as in :func:`eigh3`."""
    vals, vecs = eigh3(A)
    return vecs[..., :, 0].contiguous(), vals[..., 0].contiguous()


def eigh3(A: torch.Tensor, eps: float = 1e-20
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending ``[..., 3]``, eigenvectors ``[..., 3, 3]``
    with ``vecs[..., :, k]`` the k-th), the layout of ``torch.linalg.eigh``,
    of symmetric ``[..., 3, 3]`` batches; float32, :data:`ISO_FRAME` where
    A ≈ qI. On a CUDA tensor this is kernel eig3 (``ops/eig3_cuda.py``),
    which reports nothing to the host; elsewhere :func:`eig3_plain`.
    ``eps``, the closed form's floor, has no use here: it keeps the JAX
    package's positional order, which every public function of the port
    takes (``tests/test_torch_exports.py``)."""
    A = A.to(torch.float32)
    if A.device.type == "cuda":
        from .eig3_cuda import eig3_cuda

        return eig3_cuda(A.contiguous())
    return eig3_plain(A)
