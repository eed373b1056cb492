"""Rigid-motion solvers: point-to-point (Kabsch), similarity (Umeyama) and
point-to-plane (6x6).

Counterpart of ``fpcr_tpu/ops/solve.py``. Point-to-point: masked centroids,
the 3x3 cross-covariance as one float32 matmul, and the rotation from a 3x3
SVD (kernel svd3 on the card, ``torch.linalg.svd`` on the CPU), with the
det(R) = +1 reflection fix the reference lacks, or from the matmul-only
Newton–Schulz polar iteration; Umeyama adds the scale from the same SVD
(svd3's Umeyama form on the card). Point-to-plane:
J = [p × n, n], C = JᵀWJ and b = -JᵀWr as
float32 reductions, and the 6x6 Cholesky solve on the device, with no host
round trip. A mask may be boolean or float (IRLS weights).

Every solver takes leading batch axes, ``p`` and ``q`` [..., N, 3] with a
mask [..., N], and solves each element on its own (the JAX package's
``vmap``; ``models/batch.py``, RANSAC's hypotheses): one batched SVD, one
batched ``cholesky_ex``, a det correction per element.

Every sum over points takes ``group`` (``core/metrics.py::_psum``), as the
JAX solvers take ``axis_name``: the rows are one rank's shard and the
moments are all-reduced before the solve, sums that do not depend on each
other in one all-reduce. Kabsch makes two (centroids, cross-covariance),
Umeyama two, the plane system one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.metrics import _psum, _psum_all
from ..core.transforms import RigidTransform, rotation_zyx
from ..utils.precision import pin_f32_precision


def _weights(mask: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if mask is None:
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return mask.to(x.dtype)


def _centroid_sums(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """The two sums of a masked centroid: ``(Σ w x, Σ w)``."""
    w = _weights(mask, x)
    return torch.sum(x * w[..., None], dim=-2), w.sum(dim=-1, keepdim=True)


def masked_centroid(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """Mean of the valid (or weighted) points."""
    s, c = _psum_all(_centroid_sums(x, mask), group)
    return s / torch.clamp(c, min=1.0)


def _centroids(p: torch.Tensor, q: torch.Tensor,
               mask: Optional[torch.Tensor], group, *extra):
    """``masked_centroid`` of ``p`` and of ``q`` with one all-reduce, which
    also carries the independent sums ``extra``: ``(p̄, q̄, *extra)``."""
    sp, cp, sq, cq, *extra = _psum_all(
        _centroid_sums(p, mask) + _centroid_sums(q, mask) + extra, group)
    return (sp / torch.clamp(cp, min=1.0), sq / torch.clamp(cq, min=1.0),
            *extra)


def cross_covariance(p: torch.Tensor, q: torch.Tensor, p_bar: torch.Tensor,
                     q_bar: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """``W = Σ_i w_i (q_i - q̄)(p_i - p̄)ᵀ`` as a [3,N]x[N,3] matmul."""
    dev_p = (p - p_bar[..., None, :]) * _weights(mask, p)[..., None]
    dev_q = q - q_bar[..., None, :]
    return _psum(torch.matmul(dev_q.transpose(-1, -2), dev_p), group)


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of 3x3s as the triple product r0 · (r1 × r2): two small
    ops on the device, where ``torch.linalg.det`` would factorize."""
    return torch.sum(a[..., 0, :] * torch.linalg.cross(a[..., 1, :],
                                                       a[..., 2, :]), dim=-1)


def rotation_from_svd(W: torch.Tensor,
                      det_correction: bool = True) -> torch.Tensor:
    """Kabsch rotation ``R = U·Vᵀ`` from the 3x3 cross-covariance (or each of
    a batch ``[..., 3, 3]``), with the optional det(R) = +1 fix: the column
    of U of the smallest singular value (the last) is multiplied by
    sign(det R).

    On a CUDA tensor this is kernel svd3 (``ops/svd3_cuda.py``, float32
    only, else it raises), which reports nothing to the host: the call does
    not wait for the card, so a registration loop can run as a captured CUDA
    graph. A non-finite W gives a NaN R there, as in the JAX package. On a
    CPU tensor it is the plain version, :func:`rotation_from_svd_plain`."""
    if W.device.type == "cuda":
        from .svd3_cuda import svd3_rotation_cuda

        return svd3_rotation_cuda(W.contiguous(), det_correction)
    return rotation_from_svd_plain(W, det_correction)


def rotation_from_svd_plain(W: torch.Tensor,
                            det_correction: bool = True) -> torch.Tensor:
    """The plain PyTorch version of kernel svd3, on any device: one
    ``torch.linalg.svd``, which raises on a non-finite W and on the card
    checks its status on the host."""
    U, _, Vt = torch.linalg.svd(W, full_matrices=False)
    R = torch.matmul(U, Vt)
    if det_correction:
        U[..., :, 2] *= torch.sign(_det3(R))[..., None]
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
    norm = torch.sqrt(torch.sum(W * W, dim=(-2, -1), keepdim=True)) + 1e-30
    # scale so all singular values < sqrt(3) (the convergence region)
    X = W / norm + 1e-6 * eye
    for _ in range(iterations):
        X = 1.5 * X - 0.5 * torch.matmul(
            X, torch.matmul(X.transpose(-1, -2), X))
    ortho_err = torch.abs(torch.matmul(X, X.transpose(-1, -2)) - eye).amax(
        dim=(-2, -1), keepdim=True)
    good = torch.isfinite(X).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True) & (ortho_err < 1e-3)
    return torch.where(good, X, eye)


def kabsch_transform(p: torch.Tensor, q: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     solver: str = "svd", det_correction: bool = True,
                     group=None) -> RigidTransform:
    """Closed-form least-squares rigid transform aligning p onto q:
    centroids, cross-covariance, R by 3x3 SVD (or polar), ``t = q̄ - R·p̄``."""
    pin_f32_precision()
    p_bar, q_bar = _centroids(p, q, mask, group)
    W = cross_covariance(p, q, p_bar, q_bar, mask, group)
    if solver == "svd":
        R = rotation_from_svd(W, det_correction=det_correction)
    elif solver == "polar":
        R = rotation_polar_newton_schulz(W)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return RigidTransform(R, q_bar - _matvec(R, p_bar))


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a matrix and a vector, or batches of them."""
    if A.ndim == 2:
        return torch.matmul(A, x)
    return torch.matmul(A, x[..., None])[..., 0]


def umeyama_transform(p: torch.Tensor, q: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, *,
                      with_scale: bool = True, group=None
                      ) -> Tuple[torch.Tensor, RigidTransform]:
    """Umeyama (TPAMI 1991) similarity alignment for known correspondences:
    ``(scale, RigidTransform)`` minimising ``Σ w_i ‖q_i − (s·R·p_i + t)‖²``.
    The sign fix ``d = sign(det U · det Vᵀ)`` and the scale stay on the
    device; ``with_scale=False`` gives s = 1 and Kabsch with Umeyama's
    reflection handling."""
    pin_f32_precision()
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    w = _weights(mask, p)
    p_bar, q_bar, wsum = _centroids(p, q, mask, group, w.sum())
    wsum = torch.clamp(wsum, min=1.0)
    dev_p = p - p_bar
    W, var_p = _psum_all((cross_covariance(p, q, p_bar, q_bar, mask),
                          torch.sum(w * torch.sum(dev_p * dev_p, dim=1))),
                         group)
    W = W / wsum
    var_p = var_p / wsum
    R, trace = umeyama_from_svd(W)
    if with_scale:
        s = trace / torch.clamp(var_p, min=1e-30)
    else:
        s = torch.ones((), dtype=torch.float32, device=p.device)
    return s, RigidTransform(R, q_bar - s * torch.matmul(R, p_bar))


def umeyama_from_svd(W: torch.Tensor):
    """Umeyama's rotation and scale numerator from the normalised 3x3
    cross-covariance (or each of a batch ``[..., 3, 3]``): ``(R, trace)``
    with ``R = U·diag(1, 1, d)·Vᵀ``, ``trace = σ1 + σ2 + d·σ3`` and ``d =
    sign(det U · det Vᵀ)``, 1 where it is 0.

    On a CUDA tensor this is kernel svd3's Umeyama form
    (``ops/svd3_cuda.py::svd3_umeyama_cuda``), which reports nothing to the
    host, so a scaled ICP loop can run as a captured CUDA graph; on a CPU
    tensor the plain version, :func:`umeyama_from_svd_plain`."""
    if W.device.type == "cuda":
        from .svd3_cuda import svd3_umeyama_cuda

        return svd3_umeyama_cuda(W.contiguous())
    return umeyama_from_svd_plain(W)


def umeyama_from_svd_plain(W: torch.Tensor):
    """The plain PyTorch version of svd3's Umeyama form, on any device: one
    ``torch.linalg.svd``, which raises on a non-finite W and on the card
    checks its status on the host."""
    U, D, Vt = torch.linalg.svd(W, full_matrices=False)
    d = torch.sign(_det3(U) * _det3(Vt))
    d = torch.where(d == 0, torch.ones_like(d), d)
    U[..., :, 2] *= d[..., None]
    return torch.matmul(U, Vt), D[..., 0] + D[..., 1] + d * D[..., 2]


def plane_normal_equations(p: torch.Tensor, q: torch.Tensor,
                           normals: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, group=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 6x6 normal equations ``C x = b`` of point-to-plane ICP: per point
    ``J_i = [p_i × n_i, n_i]`` and ``r_i = (p_i - q_i)·n_i``; ``C = Σ w_i
    J_iᵀJ_i`` and ``b = -Σ w_i J_iᵀ r_i``."""
    J = torch.cat([torch.linalg.cross(p, normals), normals], dim=-1)  # [N,6]
    r = torch.sum((p - q) * normals, dim=-1)
    Jw = J * _weights(mask, p)[..., None]
    C = torch.matmul(Jw.transpose(-1, -2), J)
    b = -torch.sum(Jw * r[..., None], dim=-2)
    return _psum_all((C, b), group)


def plane_solve_update(C: torch.Tensor, b: torch.Tensor,
                       damping: float = 0.0
                       ) -> Tuple[RigidTransform, torch.Tensor]:
    """Solve ``C x = b`` by a 6x6 Cholesky on the device and rebuild the
    increment: the full Euler ``Rz·Ry·Rx`` from x[0:3] (the reference's,
    not the small-angle one) and t = x[3:6]. Returns ``(transform, x)``.

    A relative floor ``1e-7·tr(C)/6`` on the diagonal keeps the factor
    finite when the inlier set collapses. ``cholesky_ex`` reports a failed
    factorization on the device (``torch.linalg.cholesky`` would check it
    on the host, a sync per iteration, and raise); a failed or non-finite
    solve gives x = 0, the identity update. The solve is two triangular
    solves with L (cuBLAS on the card): a batched ``cholesky_solve`` would
    go through MAGMA there, which no CUDA graph can capture."""
    eye = torch.eye(6, dtype=C.dtype, device=C.device)
    if damping:
        C = C + damping * eye
    trace = C.diagonal(dim1=-2, dim2=-1).sum(dim=-1)[..., None, None]
    C = C + (1e-7 * (trace / 6.0) + 1e-30) * eye
    L, info = torch.linalg.cholesky_ex(C)
    x = torch.linalg.solve_triangular(
        L.transpose(-1, -2), torch.linalg.solve_triangular(
            L, b[..., None], upper=False), upper=True)[..., 0]
    good = (info == 0) & torch.isfinite(x).all(dim=-1)
    x = torch.where(good[..., None], x, torch.zeros_like(x))
    return RigidTransform(rotation_zyx(x[..., 0], x[..., 1], x[..., 2]),
                          x[..., 3:6]), x


def point_to_plane_transform(p: torch.Tensor, q: torch.Tensor,
                             normals: torch.Tensor,
                             mask: Optional[torch.Tensor] = None, *,
                             damping: float = 0.0,
                             group=None) -> RigidTransform:
    """One linearised point-to-plane solve: p, the matched q and the matched
    target normals give the incremental rigid transform."""
    pin_f32_precision()
    C, b = plane_normal_equations(p, q, normals, mask, group)
    return plane_solve_update(C, b, damping)[0]
