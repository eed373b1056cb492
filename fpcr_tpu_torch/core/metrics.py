"""Registration error metrics.

The reference's per-iteration error is the Frobenius RMS of the residual
between the transformed source and its matched target points,
``E = ||p - q_idx||_F / sqrt(N)``. Every metric is mask-aware; a mask may
be boolean (valid/invalid) or float (IRLS weights).
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_count(mask: Optional[torch.Tensor], n: int, dtype,
                 device=None) -> torch.Tensor:
    if mask is None:
        # a fill on the device: torch.tensor would copy from the host and
        # synchronise
        return torch.full((), float(n), dtype=dtype, device=device)
    return mask.to(dtype).sum(dim=-1)


def rmse(p: torch.Tensor, q: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sqrt(sum_i w_i ||p_i - q_i||^2 / sum_i w_i)`` over ``[N, 3]`` pairs —
    the reference's ``Snrm2 / sqrt(N)`` when ``mask`` is None; ``[B, N,
    3]`` pairs with a ``[B, N]`` mask give one value an element."""
    diff = p - q
    sq = torch.sum(diff * diff, dim=-1)
    if mask is not None:
        sq = sq * mask.to(sq.dtype)
    count = masked_count(mask, p.shape[-2], p.dtype, p.device)
    return torch.sqrt(sq.sum(dim=-1) / torch.clamp(count, min=1.0))


def transform_rmse(t_est, t_ref, probe_points: torch.Tensor) -> torch.Tensor:
    """RMS discrepancy of two transforms measured on probe points (the
    parity measure of BASELINE.md: 1e-5 on Bunny and the hall scan)."""
    return rmse(t_est.apply(probe_points), t_ref.apply(probe_points))


def evaluate_registration(source, target, transform=None, *,
                          max_correspondence_dist=None,
                          target_mask: Optional[torch.Tensor] = None,
                          source_chunk: int = 2048, target_tile: int = 2048):
    """Post-hoc quality of an alignment, the PCL/Open3D convention: apply
    ``transform`` (None = identity), match every source point to its nearest
    target point (``nn_argmin(exact=True)``: kernel K1 on a CUDA tensor) and
    report over the matches within ``max_correspondence_dist`` (None = 2x
    the target's median point spacing, ``ops.grid.suggest_cell_size``):

    * ``fitness``: inlier matches / N;
    * ``inlier_rmse``: RMS Euclidean distance over the inliers;
    * ``num_inliers``: the inlier count (int32);
    * ``max_correspondence_dist``: the gate used.

    Metric-independent, so it checks any result. Returns a dict of 0-d
    tensors on the source's device."""
    from ..core.cloud import as_points
    from ..ops.grid import suggest_cell_size
    from ..ops.matching import nn_argmin
    from ..utils.precision import pin_f32_precision

    pin_f32_precision()  # the transform's matmul too
    source = as_points(source)
    target = as_points(target, device=source.device)
    if max_correspondence_dist is None:
        max_correspondence_dist = suggest_cell_size(target, scale=2.0)
    gate = torch.as_tensor(max_correspondence_dist, dtype=torch.float32,
                           device=source.device)
    pts = source if transform is None else transform.apply(source)
    # the difference form: the expansion's ~1e-7 rounding in squared units
    # would floor the reported RMSE at ~3e-4
    _, dmin = nn_argmin(pts.contiguous(), target.contiguous(), target_mask,
                        exact=True, source_chunk=source_chunk,
                        target_tile=target_tile)
    inlier = dmin <= gate * gate
    num = inlier.sum(dtype=torch.int32)
    mse = (torch.where(inlier, torch.clamp(dmin, min=0.0),
                       torch.zeros_like(dmin)).sum()
           / torch.clamp(num, min=1).to(torch.float32))
    return {"fitness": num.to(torch.float32) / pts.shape[0],
            "inlier_rmse": torch.sqrt(mse), "num_inliers": num,
            "max_correspondence_dist": gate}
