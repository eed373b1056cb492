"""Batched closed-form symmetric 3x3 eigendecomposition on the device.

Counterpart of ``fpcr_tpu/ops/eigh3.py``: trigonometric eigenvalues
(Smith's algorithm) and cross-product eigenvectors, elementwise torch ops
over ``[..., 3, 3]`` batches, with no LAPACK call and no host round trip.

Degenerate guards, as in the JAX package:
  * isotropic A ≈ qI (p2 → 0): the eigenvalues collapse to q and the
    eigenvector falls back to (1,1,1)/√3;
  * rank-deficient cross products: the largest-norm cross of the rows of
    (A - λI) is taken, and below ``eps`` the fallback direction;
  * :func:`eigh3` completes the frame by Gram–Schmidt of the world axis
    least aligned with v_max when v_min ≈ ±v_max.
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


def smallest_eigenvector(A: torch.Tensor, eps: float = 1e-20
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvector, eigenvalue) of the smallest eigenvalue of symmetric
    ``[..., 3, 3]`` batches: the PCA surface-normal direction."""
    lam_min = eigvals3(A)[..., 0]
    return _unit_eigenvector(A, lam_min, eps), lam_min


def eigh3(A: torch.Tensor, eps: float = 1e-20
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending ``[..., 3]``, eigenvectors ``[..., 3, 3]``
    with ``vecs[..., :, k]`` the k-th), the layout of ``torch.linalg.eigh``,
    closed form and batched."""
    lams = eigvals3(A)
    v_min = _unit_eigenvector(A, lams[..., 0], eps)
    v_max = _unit_eigenvector(A, lams[..., 2], eps)
    # v_mid completes the right-handed frame; where v_min ≈ ±v_max (both
    # fallbacks, an isotropic A) it is the world axis least aligned with
    # v_max, Gram–Schmidt against it. n = sin(angle) of two unit vectors,
    # so the guard is an angle, not an absolute epsilon
    v_mid = torch.linalg.cross(v_max, v_min)
    n = torch.sqrt(torch.sum(v_mid * v_mid, dim=-1, keepdim=True))
    good = n[..., 0] > 1e-4
    axis = torch.argmin(torch.abs(v_max), dim=-1)
    e = torch.eye(3, dtype=A.dtype, device=A.device)[axis]
    t = e - v_max * torch.sum(e * v_max, dim=-1, keepdim=True)
    t = t / torch.sqrt(torch.clamp(torch.sum(t * t, dim=-1, keepdim=True),
                                   min=eps))
    v_mid = torch.where(good[..., None],
                        v_mid / torch.where(n > 0, n, torch.ones_like(n)), t)
    # re-derive v_min so the frame is orthonormal near repeated eigenvalues
    v_min_o = torch.linalg.cross(v_mid, v_max)
    nmo = torch.sqrt(torch.sum(v_min_o * v_min_o, dim=-1, keepdim=True))
    v_min_o = v_min_o / torch.where(nmo > 0, nmo, torch.ones_like(nmo))
    return lams, torch.stack([v_min_o, v_mid, v_max], dim=-1)
