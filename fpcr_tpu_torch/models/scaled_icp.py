"""Scaled ICP: similarity registration (rotation, translation and one
uniform scale) by an Umeyama solve each iteration.

Counterpart of ``fpcr_tpu/models/scaled_icp.py``, with the loop of
``models/icp.py``: masked device state, the ``done`` flag read by the host
once per ``DONE_CHECK_EVERY`` iterations, chunks of those iterations
captured as CUDA graphs on the card. The Umeyama SVD is kernel svd3's
Umeyama form there (``ops/solve.py::umeyama_from_svd``), so no iteration
waits for the card. It takes the exhaustive matchers
``'xla'`` and ``'pallas'`` only (kernel K1, or K2 for
``pallas_mode='packed6_idx'``, on a CUDA tensor): the Morton pre-sort
assumes rigid iterates.

On densely sampled surfaces nearest-neighbour matching is nearly
scale-blind and the scale estimate collapses toward 1; scale is recovered
where the true counterparts are the nearest neighbours (volumetric clouds,
or a rigid pre-alignment first).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.cloud import as_points
from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.solve import umeyama_transform
from ..utils.precision import pin_f32_precision
from .icp import (ICPConfig, _correspondences, correspondence_weights,
                  drive_chunks)


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


class _ScaledState(NamedTuple):
    """The loop state, every field on the device."""

    points: torch.Tensor
    scale: torch.Tensor
    rotation: torch.Tensor
    translation: torch.Tensor
    prev_error: torch.Tensor
    done: torch.Tensor
    num_iterations: torch.Tensor


def _scaled_chunk(state: _ScaledState, consts, k: int):
    """``k`` masked iterations of :func:`run_scaled_icp` from ``state``:
    ``(state, rows [k, 1])``, a row an iteration holding its error, NaN
    where the loop had stopped. ``consts`` is ``(target, source_mask,
    target_mask, config, with_scale)``. A pure function of its tensors: on
    the card one CUDA graph a ``k`` (``models/icp.py::drive_chunks``)."""
    target, source_mask, target_mask, config, with_scale = consts
    points, scale, rotation, translation, prev_error, done, n_it = state
    nan = torch.full((), float("nan"), device=points.device)
    rows = []
    for _ in range(k):
        q_m, _, dmin, found = _correspondences(points, target, target_mask,
                                               None, config, None)
        mask = correspondence_weights(dmin, found, config, source_mask)
        s_inc, inc = umeyama_transform(points, q_m, mask,
                                       with_scale=with_scale)
        new_points = (s_inc * torch.matmul(points, inc.rotation.T)
                      + inc.translation)
        error = rmse(new_points, q_m, mask)
        active = ~done
        rows.append(torch.where(active, error, nan)[None])
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
        n_it = n_it + active.to(torch.int32)
        done = done | (active & converged)
    return (_ScaledState(points, scale, rotation, translation, prev_error,
                         done, n_it), torch.stack(rows))


def run_scaled_icp(source, target, config: ICPConfig = ICPConfig(),
                   source_mask: Optional[torch.Tensor] = None,
                   target_mask: Optional[torch.Tensor] = None,
                   with_scale: bool = True) -> ScaledICPResult:
    """Register ``source`` onto ``target`` with a similarity transform on
    their device; ``with_scale=False`` is rigid ICP with Umeyama's
    determinant-consistent rotation.

    On the card the loop runs as CUDA graphs of ``DONE_CHECK_EVERY``
    iterations (``models/icp.py::drive_chunks``) from the second call of
    its shapes and config on; eagerly on the first, on the CPU and under
    ``graphs.eager()``."""
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

    state = _ScaledState(
        source, torch.ones((), dtype=torch.float32, device=device),
        torch.eye(3, dtype=torch.float32, device=device),
        torch.zeros(3, dtype=torch.float32, device=device),
        torch.full((), float("inf"), device=device),
        torch.zeros((), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device))
    # the chunk never reads max_iterations: one graph serves every length
    consts = (target, source_mask, target_mask,
              dataclasses.replace(config, max_iterations=0), with_scale)
    state, rows = drive_chunks(_scaled_chunk, state, consts,
                               config.max_iterations,
                               lambda st: bool(st.done), (1,))
    return ScaledICPResult(
        scale=state.scale,
        transform=RigidTransform(state.rotation, state.translation),
        errors=rows[:, 0].contiguous(),
        num_iterations=state.num_iterations, converged=state.done,
        points=state.points)
