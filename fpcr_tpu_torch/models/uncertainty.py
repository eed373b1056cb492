"""Registration uncertainty: the 6-dof pose covariance at convergence.

Counterpart of ``fpcr_tpu/models/uncertainty.py``: the Gauss-Newton (Censi
2007) approximation ``Σ_pose ≈ σ² · H⁻¹``, ``H = Σ_i J_iᵀ J_i``, at the
converged pose from one fresh correspondence pass (the configured matcher:
kernel K1 on the card for the brute one), trimmed and weighted as the ICP
loop trims and weights (``correspondence_weights``):

* plane metric: ``r_i = (p_i − q_i)·n_i``, ``J_i = [p_i×n_i, n_i]``, H the
  plane solve's ``C``;
* point metric: ``r_i = p_i − q_i``, ``J_i = [−[p_i]× | I]``, H in closed
  form.

``σ²`` defaults to the residual variance per degree of freedom. The [θ, t]
covariance becomes a ``[ρ, w]`` information matrix for the pose graph with
:func:`information_from_covariance`, transported by the port's own
``se3_adjoint`` and ``se3_inv``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.cloud import as_points
from ..core.transforms import RigidTransform, skew
from ..ops.morton import source_morton_order
from ..ops.normals import estimate_normals
from ..ops.solve import plane_normal_equations
from ..utils.precision import pin_f32_precision
from .icp import (ICPConfig, _correspondences, build_matcher_state,
                  correspondence_weights)
from .pose_graph import _homogeneous, se3_adjoint, se3_inv


def registration_covariance(source, target, transform: RigidTransform,
                            config: Optional[ICPConfig] = None, *,
                            sigma2: Optional[float] = None,
                            target_normals: Optional[torch.Tensor] = None,
                            target_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """6×6 pose covariance (order ``[θx θy θz, tx ty tz]``) of a converged
    registration, from one correspondence pass at the final pose, on the
    source's device. Uses ``config``'s matcher and metric (the point
    metric by default)."""
    pin_f32_precision()
    config = config or ICPConfig()
    src = transform.apply(as_points(source)).contiguous()
    tgt = as_points(target, device=src.device).contiguous()
    if config.metric in ("plane", "symmetric", "gicp") and \
            target_normals is None:
        target_normals = estimate_normals(
            tgt, k=config.k_neighbors, mask=target_mask,
            banded_threshold=config.normals_banded_threshold)
    state = build_matcher_state(tgt, target_mask, config, target_normals)
    if config.matcher == "morton":
        # H and σ² are sums over points: the band matcher's sort is harmless
        # as long as each p_i stays paired with its q_i
        src = src[source_morton_order(src, state[0][0]).long()].contiguous()
    q_m, n_m, dmin, found = _correspondences(
        src, tgt, target_mask, target_normals, config, state)
    mask = correspondence_weights(dmin, found, config)
    w = (torch.ones(src.shape[0], device=src.device) if mask is None
         else mask.to(torch.float32))
    n_eff = torch.clamp(w.sum(), min=1.0)

    if n_m is not None:  # plane model: H is the plane solve's C
        H, _ = plane_normal_equations(src, q_m, n_m, mask=w)
        r = torch.sum((src - q_m) * n_m, dim=1)
        s2 = torch.sum(w * r * r) / n_eff
    else:
        # point model, closed form: H_tt = n_eff I, H_θθ = Σ w (|p|² I −
        # p pᵀ), H_θt = Σ w [p]×
        x = src * w[:, None]
        pp = torch.matmul(x.T, src)
        eye3 = torch.eye(3, device=src.device)
        sx = skew(x.sum(dim=0))
        H = torch.cat([torch.cat([torch.trace(pp) * eye3 - pp, sx], dim=1),
                       torch.cat([sx.T, n_eff * eye3], dim=1)])
        r = src - q_m
        s2 = torch.sum(w[:, None] * r * r) / (3.0 * n_eff)
    if sigma2 is not None:
        s2 = torch.full((), float(sigma2), device=src.device)
    eye6 = torch.eye(6, device=src.device)
    cov = s2 * torch.linalg.inv(H + (1e-9 * (torch.trace(H) / 6.0) + 1e-30)
                                * eye6)
    return 0.5 * (cov + cov.T)  # symmetrize away inversion noise


def information_from_covariance(cov_tt: torch.Tensor,
                                transform: Optional[RigidTransform] = None
                                ) -> torch.Tensor:
    """[θ, t]-ordered registration covariance → [ρ, w]-ordered 6×6
    information matrix in the pose graph's right-tangent convention
    (``Z = Ẑ·exp(ε)``). The Censi covariance describes a left perturbation
    of the estimate, so with the converged ``transform`` (the edge
    measurement Ẑ) it is transported by ``Ad(Ẑ⁻¹)``: required for edges
    far from identity. ``None`` keeps the near-identity approximation."""
    pin_f32_precision()
    perm = torch.tensor([3, 4, 5, 0, 1, 2], device=cov_tt.device)
    cov_rw = cov_tt[perm][:, perm]
    if transform is not None:
        A = se3_adjoint(se3_inv(_homogeneous(
            transform.rotation.to(torch.float32),
            transform.translation.to(torch.float32))))
        cov_rw = torch.matmul(A, torch.matmul(cov_rw, A.T))
    floor = 1e-12 * (torch.trace(cov_rw) / 6.0) + 1e-30
    return torch.linalg.inv(cov_rw + floor * torch.eye(6,
                                                       device=cov_tt.device))
