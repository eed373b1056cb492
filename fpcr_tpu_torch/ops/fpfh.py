"""FPFH descriptors (Fast Point Feature Histograms, Rusu et al. ICRA 2009),
the local geometric feature of global registration.

Counterpart of ``fpcr_tpu/ops/fpfh.py``. Neighbour pairs come from the
streaming ``self_knn`` (``ops/normals.py``); the Darboux angle features
(alpha, phi, theta) of every (point, neighbour) pair are one batched
``[N, k]`` computation; each histogram is a one-hot encode summed over the
neighbour axis, as the JAX package builds it, a dense reduction whose sums
are deterministic on both devices (no scatter, no atomics); SPFH → FPFH
mixes the neighbours' SPFH weighted by 1/distance. Normals must be
consistently oriented (``ops.normals.orient_normals``) for the angles'
signs to mean anything; ``models/global_reg.py`` orients them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .normals import self_knn

_EPS = 1e-12


def _pair_features(p_i, n_i, p_j, n_j):
    """Darboux-frame angle features of point pairs: p_i, n_i [N, 1, 3]
    query points and normals, p_j, n_j [N, k, 3] their neighbours. Returns
    ``(f1, f2, f3, dist)``: f1 = v·n_j, f2 = u·d̂, f3 = atan2(w·n_j, u·n_j),
    dist = ‖p_j − p_i‖."""
    d = p_j - p_i  # [N, k, 3]
    dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=0.0))
    dn = d / torch.clamp(dist[..., None], min=_EPS)
    u = n_i.expand_as(dn)
    v = torch.linalg.cross(dn, u)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=_EPS)
    w = torch.linalg.cross(u, v)
    f1 = torch.sum(v * n_j, dim=-1)
    f2 = torch.sum(u * dn, dim=-1)
    f3 = torch.atan2(torch.sum(w * n_j, dim=-1), torch.sum(u * n_j, dim=-1))
    return f1, f2, f3, dist


def _hist(values, lo, hi, bins: int, weights):
    """Weighted histogram ``[N, bins]`` over the neighbour axis of
    ``values`` / ``weights`` [N, k], by one-hot sums."""
    t = (values - lo) / (hi - lo) * bins
    b = torch.clamp(t.to(torch.int32), 0, bins - 1)  # truncation, as astype
    onehot = b[..., None] == torch.arange(bins, device=values.device)
    return torch.sum(onehot * weights[..., None], dim=1)


def fpfh_features(points: torch.Tensor, normals: torch.Tensor, k: int = 16,
                  mask: Optional[torch.Tensor] = None, *, bins: int = 11,
                  chunk: int = 1024, tile: int = 2048,
                  banded_threshold: int = 100_000) -> torch.Tensor:
    """FPFH descriptor ``[N, 3*bins]`` of every point (33-D by default, the
    PCL layout): SPFH(p) histograms the three Darboux angles over p's k
    neighbours, FPFH(p) = SPFH(p) + (1/k) Σ_j SPFH(p_j)/dist_j, each
    sub-histogram L1-normalized. ``mask`` rows (padded points) get zero
    descriptors."""
    points = points.to(torch.float32)
    normals = normals.to(torch.float32)
    idx_all, sqd_all = self_knn(points, k + 1, mask, chunk=chunk, tile=tile,
                                banded_threshold=banded_threshold)
    nbr_idx = idx_all[:, 1:].long()  # drop self
    nbr_sqd = torch.clamp(sqd_all[:, 1:], min=0.0)
    f1, f2, f3, dist = _pair_features(points[:, None, :],
                                      normals[:, None, :], points[nbr_idx],
                                      normals[nbr_idx])
    # degenerate pairs (duplicate points) and pairs into padded neighbours
    # contribute nothing
    wpair = (dist > 1e-9).to(torch.float32)
    if mask is not None:
        wpair = wpair * mask.to(torch.float32)[nbr_idx]
    spfh = torch.cat([_hist(f1, -1.0, 1.0, bins, wpair),
                      _hist(f2, -1.0, 1.0, bins, wpair),
                      _hist(f3, -math.pi, math.pi, bins, wpair)], dim=1)
    # FPFH mixing: the neighbours' SPFH weighted by 1/distance
    inv_d = 1.0 / torch.clamp(torch.sqrt(nbr_sqd), min=1e-6)
    fpfh = spfh + torch.sum(spfh[nbr_idx] * (inv_d * wpair)[..., None],
                            dim=1) / float(k)
    # L1-normalize each of the three sub-histograms
    parts = fpfh.reshape(-1, 3, bins)
    fpfh = (parts / torch.clamp(parts.sum(dim=2, keepdim=True), min=_EPS)
            ).reshape(-1, 3 * bins)
    if mask is not None:
        fpfh = fpfh * mask.to(torch.float32)[:, None]
    return fpfh
