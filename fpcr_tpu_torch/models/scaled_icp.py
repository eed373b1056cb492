"""Scaled ICP: similarity registration (rotation, translation and one
uniform scale) by an Umeyama solve each iteration.

Counterpart of ``fpcr_tpu/models/scaled_icp.py``, with the loop of
``models/icp.py``: masked device state, the ``done`` flag read by the host
once per ``DONE_CHECK_EVERY`` iterations. It takes the exhaustive matchers
``'xla'`` and ``'pallas'`` only (kernel K1, or K2 for
``pallas_mode='packed6_idx'``, on a CUDA tensor): the Morton pre-sort
assumes rigid iterates.

On densely sampled surfaces nearest-neighbour matching is nearly
scale-blind and the scale estimate collapses toward 1; scale is recovered
where the true counterparts are the nearest neighbours (volumetric clouds,
or a rigid pre-alignment first).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.cloud import as_points
from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.solve import umeyama_transform
from ..utils.precision import pin_f32_precision
from .icp import (DONE_CHECK_EVERY, ICPConfig, _correspondences, _nan_padded,
                  correspondence_weights)


class ScaledICPResult(NamedTuple):
    scale: torch.Tensor  # accumulated uniform scale
    transform: RigidTransform  # rotation and translation of x -> s·R·x + t
    errors: torch.Tensor  # [max_iterations] RMSE, NaN after the stop
    num_iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool
    points: torch.Tensor  # final transformed source cloud

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Apply the similarity ``x -> s·R·x + t``."""
        return (self.scale * torch.matmul(points, self.transform.rotation.T)
                + self.transform.translation)


def run_scaled_icp(source, target, config: ICPConfig = ICPConfig(),
                   source_mask: Optional[torch.Tensor] = None,
                   target_mask: Optional[torch.Tensor] = None,
                   with_scale: bool = True) -> ScaledICPResult:
    """Register ``source`` onto ``target`` with a similarity transform on
    their device; ``with_scale=False`` is rigid ICP with Umeyama's
    determinant-consistent rotation."""
    if config.matcher not in ("xla", "pallas"):
        raise ValueError(
            "run_scaled_icp supports the exhaustive matchers 'xla'|'pallas' "
            f"(got {config.matcher!r})")
    pin_f32_precision()
    source = as_points(source).contiguous()
    device = source.device
    target = as_points(target, device=device).contiguous()
    if source_mask is not None:
        source_mask = source_mask.to(device)
    if target_mask is not None:
        target_mask = target_mask.to(device).contiguous()

    nan = torch.full((), float("nan"), device=device)
    points = source
    scale = torch.ones((), dtype=torch.float32, device=device)
    rotation = torch.eye(3, dtype=torch.float32, device=device)
    translation = torch.zeros(3, dtype=torch.float32, device=device)
    prev_error = torch.full((), float("inf"), device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors = []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        q_m, _, dmin, found = _correspondences(points, target, target_mask,
                                               None, config, None)
        mask = correspondence_weights(dmin, found, config, source_mask)
        s_inc, inc = umeyama_transform(points, q_m, mask,
                                       with_scale=with_scale)
        new_points = (s_inc * torch.matmul(points, inc.rotation.T)
                      + inc.translation)
        error = rmse(new_points, q_m, mask)
        active = ~done
        errors.append(torch.where(active, error, nan))
        converged = (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        # similarity composition: (s_i, R_i, t_i) ∘ (s, R, t)
        points = torch.where(active, new_points, points)
        translation = torch.where(
            active, s_inc * torch.matmul(inc.rotation, translation)
            + inc.translation, translation)
        rotation = torch.where(active, torch.matmul(inc.rotation, rotation),
                               rotation)
        scale = torch.where(active, s_inc * scale, scale)
        prev_error = torch.where(active, error, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)
    return ScaledICPResult(
        scale=scale, transform=RigidTransform(rotation, translation),
        errors=_nan_padded(errors, config.max_iterations, device),
        num_iterations=num_iterations, converged=done, points=points)
