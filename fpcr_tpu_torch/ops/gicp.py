"""Generalized-ICP (plane-to-plane) solver: one anisotropic 6x6
Gauss-Newton step on the device.

Counterpart of ``fpcr_tpu/ops/gicp.py``. GICP (Segal, Haehnel & Thrun, RSS
2009) minimises the Mahalanobis residual

    sum_i  d_i^T (C_q_i + R C_p_i R^T)^{-1} d_i ,   d_i = T(p_i) - q_i,

with surface covariances from the normals, ``C = I - (1-eps) n n^T``
(eigenvalues (eps, 1, 1)). The per-point metric ``M_i = (C_p_i +
C_q_i)^{-1}`` is never formed: Woodbury gives ``M = I/2 + a ãᵀ + b b̃ᵀ``
with a, b the two unit normals and ã, b̃ their mix by a closed-form 2x2, so
H and g are [N,3] cross products and [3,N]x[N,3] float32 matmuls
(``torch.matmul``; no [N,3,3] array). :func:`inv3x3_sym`, the dense
adjugate inverse, stays as the general-covariance reference the tests hold
the Woodbury form against. The solve is the plane solve's 6x6 Cholesky on
the device, with an identity update where the factor fails, and the
rotation is the exact SO(3) exponential. ``group`` all-reduces H and g
in one call when the rows are a rank's shard, as JAX's ``axis_name`` psums
them.

Every function takes leading batch axes (``[..., N, 3]`` rows, masks
``[..., N]``) and treats each element on its own, the JAX package's
``vmap`` (``models/batch.py``): the Woodbury products become batched
``[3, N] x [N, 3]`` matmuls and the solve a batched 6x6 ``cholesky_ex``
with two triangular solves, routes a CUDA graph captures.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.metrics import _psum_all
from ..core.transforms import RigidTransform, rotation_exp
from ..utils.precision import pin_f32_precision


def normal_covariances(normals: torch.Tensor, epsilon: float) -> torch.Tensor:
    """GICP surface covariances ``[N,3,3]`` from unit normals: ``C = I -
    (1-eps) n nᵀ``, the eps axis along the normal."""
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device)
    return eye - (1.0 - epsilon) * (normals[..., :, None]
                                    * normals[..., None, :])


def inv3x3_sym(A: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    """Closed-form inverse of symmetric 3x3 matrices ``[N,3,3]`` by the
    adjugate; ``floor`` guards the determinant of a (numerically) singular
    input. GICP's ``A = 2I - PSD`` has eigenvalues >= 2 eps, so the guard
    never binds on valid data."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    e, f = A[..., 1, 1], A[..., 1, 2]
    i = A[..., 2, 2]
    A11 = e * i - f * f
    A12 = c * f - b * i
    A13 = b * f - c * e
    A22 = a * i - c * c
    A23 = b * c - a * f
    A33 = a * e - b * b
    det = a * A11 + b * A12 + c * A13
    guard = torch.where(det >= 0, torch.full_like(det, floor),
                        torch.full_like(det, -floor))
    inv_det = 1.0 / torch.where(det.abs() > floor, det, guard)
    M = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                     torch.stack([A12, A22, A23], dim=-1),
                     torch.stack([A13, A23, A33], dim=-1)], dim=-2)
    return M * inv_det[..., None, None]


def _skew(p: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices ``[N,3,3]`` with ``S_i v = p_i x v``."""
    zeros = torch.zeros_like(p[..., 0])
    return torch.stack([
        torch.stack([zeros, -p[..., 2], p[..., 1]], dim=-1),
        torch.stack([p[..., 2], zeros, -p[..., 0]], dim=-1),
        torch.stack([-p[..., 1], p[..., 0], zeros], dim=-1),
    ], dim=-2)


def _unit(n: torch.Tensor) -> torch.Tensor:
    # renormalised: ||n|| > 1 makes C = I - (1-eps) n nᵀ indefinite, which
    # can drive A near singular when the two normals align (convergence)
    n = n.to(torch.float32)
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                           min=1e-12)


def gicp_normal_equations(p: torch.Tensor, q: torch.Tensor,
                          source_normals: torch.Tensor,
                          target_normals: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          epsilon: float = 1e-3, group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 6x6 GICP system ``H x = -g`` linearised at the current pose
    (``p`` transformed, ``source_normals`` rotated to it). Residual model
    r(x) = r0 - S_i w + t with r0 = p - q, S = skew(p), x = (w, t), per-point
    metric M_i = (C_p_i + C_q_i)^{-1}. Returns ``(H [6,6], g [6])`` with the
    mask's weights applied, or ``[..., 6, 6]`` and ``[..., 6]`` for rows
    with leading batch axes."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    a = _unit(source_normals)
    b = _unit(target_normals)
    r0 = p - q
    rows, dev = p.shape[:-1], p.device

    # A = 2I - alpha (a aᵀ + b bᵀ)  =>  M = A^{-1} = I/2 + G E Gᵀ, G = [a b],
    # E the symmetric 2x2 from kappa = 1/2 - 1/alpha and c = a·b
    alpha = 1.0 - epsilon
    if alpha <= 0.0:  # epsilon >= 1: both covariances are I, M = I/2
        e11 = e12 = e22 = torch.zeros(rows, dtype=torch.float32, device=dev)
    else:
        c = torch.sum(a * b, dim=-1)
        kappa = 0.5 - 1.0 / alpha  # <= -1/2 for alpha <= 1
        # > 0 for eps > 0; the floor mirrors inv3x3_sym's guard, for
        # direct calls with eps -> 0 and parallel normals
        det = torch.clamp(kappa * kappa - 0.25 * c * c, min=1e-12)
        s = -1.0 / (4.0 * det)
        e11 = s * kappa
        e12 = -0.5 * s * c
        e22 = s * kappa
    at = e11[..., None] * a + e12[..., None] * b  # ã  (M = I/2 + a ãᵀ + b b̃ᵀ)
    bt = e12[..., None] * a + e22[..., None] * b  # b̃

    w = None if mask is None else mask.to(torch.float32)

    def wsum(x):  # Σ w_i x_i over points: x [..., N] or [..., N, 3]
        axis = -2 if x.ndim > len(rows) else -1
        if w is not None:
            x = x * (w[..., None] if axis == -2 else w)
        return torch.sum(x, dim=axis)

    def mm(x, y):  # Σ w_i x_i y_iᵀ as a [3,N]x[N,3] matmul
        xw = x if w is None else x * w[..., None]
        return torch.matmul(xw.transpose(-1, -2), y)

    def skew3(v):
        zero = torch.zeros_like(v[..., 0])
        return torch.stack([
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)], dim=-2)

    def cross(x, y):
        return torch.linalg.cross(x, y, dim=-1)

    Mr = (0.5 * r0 + a * torch.sum(at * r0, dim=-1, keepdim=True)
          + b * torch.sum(bt * r0, dim=-1, keepdim=True))  # M r0
    g2 = wsum(Mr)
    g1 = wsum(cross(p, Mr))  # (-S)ᵀ M r0 = p x (M r0)

    axp = cross(a, p)  # Sᵀ a = a x p
    bxp = cross(b, p)
    atxp = cross(at, p)
    btxp = cross(bt, p)

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    n_w = wsum(torch.ones(rows, dtype=torch.float32, device=dev))
    B22 = (0.5 * n_w[..., None, None] * eye + mm(a, at)
           + mm(b, bt))  # Σ w M
    B12 = -(-0.5 * skew3(wsum(p)) + mm(axp, at) + mm(bxp, bt))  # -Σ w SᵀM
    p_sq = wsum(torch.sum(p * p, dim=-1))
    # Σ w SᵀMS = Σ w [(|p|²I - p pᵀ)/2 + (a x p)(ã x p)ᵀ + (b x p)(b̃ x p)ᵀ]
    B11 = (0.5 * (p_sq[..., None, None] * eye - mm(p, p)) + mm(axp, atxp)
           + mm(bxp, btxp))
    H = torch.cat([torch.cat([B11, B12], dim=-1),
                   torch.cat([B12.transpose(-1, -2), B22], dim=-1)], dim=-2)
    return _psum_all((H, torch.cat([g1, g2], dim=-1)), group)


def gicp_solve_update(H: torch.Tensor, g: torch.Tensor, damping: float = 0.0
                      ) -> Tuple[RigidTransform, torch.Tensor]:
    """Solve ``H x = -g`` by a 6x6 Cholesky on the device and rebuild the
    increment with the SO(3) exponential: ``(transform, x)``. The plane
    solve's relative floor ``1e-7·tr(H)/6`` sits on the diagonal; a failed
    factor (``cholesky_ex`` reports it on the device, with no host check)
    or a non-finite x gives x = 0, the identity update (a line cloud makes
    every normal pair parallel and H indefinite). ``H`` [..., 6, 6] and
    ``g`` [..., 6] solve each element on its own. The solve is two
    triangular solves with L, as the plane solve's: a batched
    ``cholesky_solve`` goes through MAGMA on the card, which no CUDA graph
    captures."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    if damping:
        H = H + damping * eye
    trace = H.diagonal(dim1=-2, dim2=-1).sum(dim=-1)[..., None, None]
    H = H + (1e-7 * (trace / 6.0) + 1e-30) * eye
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.linalg.solve_triangular(
        L.transpose(-1, -2), torch.linalg.solve_triangular(
            L, -g[..., None], upper=False), upper=True)[..., 0]
    good = (info == 0) & torch.isfinite(x).all(dim=-1)
    x = torch.where(good[..., None], x, torch.zeros_like(x))
    return (RigidTransform(rotation_exp(x[..., :3]).to(H.dtype),
                           x[..., 3:6]), x)


def gicp_transform(p: torch.Tensor, q: torch.Tensor,
                   source_normals: torch.Tensor, target_normals: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *,
                   epsilon: float = 1e-3, damping: float = 0.0,
                   group=None) -> RigidTransform:
    """One GICP Gauss-Newton step: the current points, their matched
    targets and both clouds' normals (the source's rotated to the current
    pose) give the incremental rigid transform."""
    pin_f32_precision()
    H, g = gicp_normal_equations(p, q, source_normals, target_normals, mask,
                                 epsilon=epsilon, group=group)
    return gicp_solve_update(H, g, damping)[0]
