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
        return torch.tensor(float(n), dtype=dtype, device=device)
    return mask.to(dtype).sum()


def rmse(p: torch.Tensor, q: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sqrt(sum_i w_i ||p_i - q_i||^2 / sum_i w_i)`` over ``[N, 3]`` pairs —
    the reference's ``Snrm2 / sqrt(N)`` when ``mask`` is None."""
    diff = p - q
    sq = torch.sum(diff * diff, dim=-1)
    if mask is not None:
        sq = sq * mask.to(sq.dtype)
    count = masked_count(mask, p.shape[0], p.dtype, p.device)
    return torch.sqrt(sq.sum() / torch.clamp(count, min=1.0))


def transform_rmse(t_est, t_ref, probe_points: torch.Tensor) -> torch.Tensor:
    """RMS discrepancy of two transforms measured on probe points (the
    parity measure of BASELINE.md: 1e-5 on Bunny and the hall scan)."""
    return rmse(t_est.apply(probe_points), t_ref.apply(probe_points))
