"""Batched registration: many cloud pairs in one loop on the device.

Counterpart of ``fpcr_tpu/models/batch.py``. :func:`register_batch`
registers ``sources[b]`` onto ``targets[b]`` for every b and returns an
``ICPResult`` whose fields carry a leading batch axis, each element's values
those of its own ``run_icp``: the serving path (B scenes a request), and the
engine of odometry and loop-closure verification.

The JAX package ``vmap``s its whole loop, and ``vmap`` adds a batch axis to
the Pallas K1's grid. Here the batch axis is written out. For the point and
plane metrics with the brute matcher (``matcher`` 'xla' or 'pallas'; K2
under ``pallas_mode='packed6_idx'``) the state of all B elements (points,
transform, previous error, done flag, iteration count) lives in ``[B, ...]``
tensors, and each iteration makes one batched matcher call: on the card one
launch pair of K1 or K2 for the whole batch, the element on ``blockIdx.z``.
The trimmed means, the IRLS weights, the Kabsch SVD with its det correction
and the plane's 6x6 ``cholesky_ex`` run per element along the batch axis.
An element that has converged is a masked no-op, as under ``vmap``; the host
reads the ``done`` flags once per ``DONE_CHECK_EVERY`` iterations, as
``run_icp`` does, and stops when every element is done. The plane metric's
normals prepass runs element by element: it is paid once.

Every other config (the morton and grid matchers, the symmetric and gicp
metrics) registers element by element through ``run_icp`` and stacks the
results, which are equal; the route is chosen by the config alone.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.matching import gather_correspondences
from ..ops.solve import kabsch_transform, point_to_plane_transform
from ..utils.device import resolve_device
from ..utils.precision import pin_f32_precision
from .icp import (DONE_CHECK_EVERY, ICPConfig, ICPResult, _match,
                  _matched_fraction, _normals_prepass,
                  correspondence_weights, rotation_angle, run_icp)


def batched_route(config: ICPConfig) -> bool:
    """Whether ``config`` runs the batched loop (one matcher call an
    iteration for the whole batch) rather than one ``run_icp`` an
    element."""
    return (config.metric in ("point", "plane")
            and config.matcher in ("xla", "pallas"))


def _as_batch(x, name: str, device=None) -> torch.Tensor:
    """A ``[B, N, 3]`` contiguous float32 tensor; a tensor keeps its device
    unless ``device`` is given, anything else lands on the card by
    default."""
    if device is None and not isinstance(x, torch.Tensor):
        device = resolve_device()
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"{name} must be [B, N, 3], got {tuple(x.shape)}")
    return x.contiguous()


def _apply(R: torch.Tensor, t: torch.Tensor,
           points: torch.Tensor) -> torch.Tensor:
    """``points[b] @ R[b]ᵀ + t[b]`` for every element."""
    return torch.matmul(points, R.transpose(1, 2)) + t[:, None, :]


def _iteration(points, targets, normals, config: ICPConfig):
    """One ICP iteration of every element: ``(new_points, increment,
    error [B], matched_fraction)``, one batched matcher call."""
    idx, dmin, _ = _match(points, targets, None, config)
    q_m = gather_correspondences(targets, idx)
    mask = correspondence_weights(dmin, None, config)
    frac = _matched_fraction(mask, None, points.shape[1], points.device)
    if config.metric == "point":
        inc = kabsch_transform(
            points, q_m, mask, solver=config.solver,
            det_correction=config.det_correction
            and not config.strict_reference)
    else:
        inc = point_to_plane_transform(
            points, q_m, gather_correspondences(normals, idx), mask,
            damping=config.damping)
    new_points = _apply(inc.rotation, inc.translation, points)
    return new_points, inc, rmse(new_points, q_m, mask), frac


def _batched_loop(sources, targets, normals, config: ICPConfig) -> ICPResult:
    b, device = sources.shape[0], sources.device
    nan = torch.full((), float("nan"), device=device)
    points = sources
    rot = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
    trans = torch.zeros((b, 3), device=device)
    prev_error = torch.full((b,), float("inf"), device=device)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    num_iterations = torch.zeros(b, dtype=torch.int32, device=device)
    errors, fractions, delta_t, delta_rot = [], [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        new_points, inc, error, frac = _iteration(points, targets, normals,
                                                  config)
        active = ~done
        errors.append(torch.where(active, error, nan))
        fractions.append(torch.where(active, frac, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(
            inc.translation, dim=-1), nan))
        delta_rot.append(torch.where(active, rotation_angle(inc.rotation),
                                     nan))
        converged = (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        a3 = active[:, None, None]
        points = torch.where(a3, new_points, points)
        trans = torch.where(active[:, None], torch.matmul(
            inc.rotation, trans[:, :, None])[:, :, 0] + inc.translation,
            trans)
        rot = torch.where(a3, torch.matmul(inc.rotation, rot), rot)
        prev_error = torch.where(active, error, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)

    def rows(values):  # [B, max_iterations], NaN after the stop
        out = torch.full((b, config.max_iterations), float("nan"),
                         device=device)
        if values:
            out[:, :len(values)] = torch.stack(values, dim=1)
        return out

    return ICPResult(transform=RigidTransform(rot, trans),
                     errors=rows(errors), num_iterations=num_iterations,
                     converged=done, points=points,
                     matched_fraction=rows(fractions),
                     delta_t=rows(delta_t), delta_rot=rows(delta_rot))


def _stack_results(results: List[ICPResult]) -> ICPResult:
    """One ``ICPResult`` with a leading batch axis from per-element ones."""
    return ICPResult(
        transform=RigidTransform(
            torch.stack([r.transform.rotation for r in results]),
            torch.stack([r.transform.translation for r in results])),
        **{name: torch.stack([getattr(r, name) for r in results])
           for name in ICPResult._fields[1:]})


def register_batch(sources, targets, config: ICPConfig = ICPConfig(),
                   target_normals: Optional[torch.Tensor] = None
                   ) -> ICPResult:
    """Register ``sources[b]`` onto ``targets[b]`` for every b, on the
    sources' device.

    Args:
      sources: ``[B, N, 3]``; targets: ``[B, M, 3]``;
      target_normals: optional ``[B, M, 3]`` (the plane metric estimates
        them, element by element, when not given).

    Returns an ``ICPResult`` whose fields carry the leading batch axis:
    ``transform`` holds rotations ``[B, 3, 3]`` and translations ``[B, 3]``,
    the per-iteration rows are ``[B, max_iterations]``.
    """
    pin_f32_precision()
    sources = _as_batch(sources, "sources")
    targets = _as_batch(targets, "targets", device=sources.device)
    if targets.shape[0] != sources.shape[0]:
        raise ValueError(f"{sources.shape[0]} sources but "
                         f"{targets.shape[0]} targets")
    if target_normals is not None:
        target_normals = _as_batch(target_normals, "target_normals",
                                   device=sources.device)
    if not batched_route(config):
        return _stack_results([
            run_icp(sources[k], targets[k], config, target_normals=(
                None if target_normals is None else target_normals[k]))
            for k in range(sources.shape[0])])
    if config.metric == "plane" and target_normals is None:
        target_normals = torch.stack([_normals_prepass(t, None, config)
                                      for t in targets]).contiguous()
    return _batched_loop(sources, targets, target_normals, config)
