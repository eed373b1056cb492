"""Point-to-point rigid solve (Kabsch).

Counterpart of the point half of ``fpcr_tpu/ops/solve.py``: masked
centroids, the 3x3 cross-covariance as one float32 matmul, and the rotation
from a 3x3 SVD on the device of the inputs (``torch.linalg.svd``), with the
det(R) = +1 reflection fix the reference lacks, or from the matmul-only
Newton–Schulz polar iteration. A mask may be boolean or float (IRLS
weights).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.transforms import RigidTransform
from ..utils.precision import pin_f32_precision


def _weights(mask: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if mask is None:
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return mask.to(x.dtype)


def masked_centroid(x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of the valid (or weighted) points."""
    w = _weights(mask, x)
    return torch.sum(x * w[:, None], dim=0) / torch.clamp(w.sum(), min=1.0)


def cross_covariance(p: torch.Tensor, q: torch.Tensor, p_bar: torch.Tensor,
                     q_bar: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``W = Σ_i w_i (q_i - q̄)(p_i - p̄)ᵀ`` as a [3,N]x[N,3] matmul."""
    dev_p = (p - p_bar) * _weights(mask, p)[:, None]
    dev_q = q - q_bar
    return torch.matmul(dev_q.T, dev_p)


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of a 3x3 as the triple product r0 · (r1 × r2): two small
    ops on the device, where ``torch.linalg.det`` would factorize."""
    return torch.dot(a[0], torch.linalg.cross(a[1], a[2]))


def rotation_from_svd(W: torch.Tensor,
                      det_correction: bool = True) -> torch.Tensor:
    """Kabsch rotation ``R = U·Vᵀ`` from the 3x3 cross-covariance, with the
    optional det(R) = +1 fix: the column of U of the smallest singular value
    (the last) is multiplied by sign(det R)."""
    U, _, Vt = torch.linalg.svd(W, full_matrices=False)
    R = torch.matmul(U, Vt)
    if det_correction:
        U[:, 2] *= torch.sign(_det3(R))
        R = torch.matmul(U, Vt)
    return R


def rotation_polar_newton_schulz(W: torch.Tensor,
                                 iterations: int = 16) -> torch.Tensor:
    """Orthogonal polar factor of W by Newton–Schulz iteration (matmuls
    only); equals U·Vᵀ for nonsingular W.

    A rank-deficient W (a 1-D line cloud, where registration itself is
    underdetermined) leaves null singular values near 0 and a non-orthogonal
    limit. A relative ridge keeps the singular values positive, and a final
    check falls back to the identity when the limit is not orthogonal or not
    finite, rather than returning a projection as a rotation."""
    eye = torch.eye(3, dtype=W.dtype, device=W.device)
    norm = torch.sqrt(torch.sum(W * W)) + 1e-30
    # scale so all singular values < sqrt(3) (the convergence region)
    X = W / norm + 1e-6 * eye
    for _ in range(iterations):
        X = 1.5 * X - 0.5 * torch.matmul(X, torch.matmul(X.T, X))
    ortho_err = torch.max(torch.abs(torch.matmul(X, X.T) - eye))
    good = torch.isfinite(X).all() & (ortho_err < 1e-3)
    return torch.where(good, X, eye)


def kabsch_transform(p: torch.Tensor, q: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     solver: str = "svd",
                     det_correction: bool = True) -> RigidTransform:
    """Closed-form least-squares rigid transform aligning p onto q:
    centroids, cross-covariance, R by 3x3 SVD (or polar), ``t = q̄ - R·p̄``."""
    pin_f32_precision()
    p_bar = masked_centroid(p, mask)
    q_bar = masked_centroid(q, mask)
    W = cross_covariance(p, q, p_bar, q_bar, mask)
    if solver == "svd":
        R = rotation_from_svd(W, det_correction=det_correction)
    elif solver == "polar":
        R = rotation_polar_newton_schulz(W)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return RigidTransform(R, q_bar - torch.matmul(R, p_bar))
