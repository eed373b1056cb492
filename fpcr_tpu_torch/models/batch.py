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
``run_icp`` does, and stops when every element is done. On the card those
iterations are one replay of a CUDA graph from the second call of the
batch's shapes and config on, as ``run_icp``'s are
(``models/icp.py::drive_chunks``; the JAX package's loop is one ``jit``).
The plane metric's normals prepass runs element by element: it is paid
once.

Every other config (the morton and grid matchers, the symmetric and gicp
metrics) registers element by element through ``run_icp`` and stacks the
results, which are equal; the route is chosen by the config alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch

from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.matching import gather_correspondences
from ..ops.solve import kabsch_transform, point_to_plane_transform
from ..utils.device import resolve_device
from ..utils.precision import pin_f32_precision
from .icp import (ICPConfig, ICPResult, _match, _matched_fraction,
                  _normals_prepass, correspondence_weights, drive_chunks,
                  rotation_angle, run_icp)


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


class _BatchState(NamedTuple):
    """The state of every element, ``[B, ...]`` on the device."""

    points: torch.Tensor
    rotation: torch.Tensor
    translation: torch.Tensor
    prev_error: torch.Tensor
    done: torch.Tensor
    num_iterations: torch.Tensor


def _batch_chunk(state: _BatchState, consts, k: int):
    """``k`` masked iterations of every element: ``(state, rows [k, 4,
    B])`` (error, matched fraction, ‖Δt‖, ∠ΔR, NaN where an element had
    stopped). ``consts`` is ``(targets, normals, config)``. A pure function
    of its tensors: on the card one CUDA graph a ``k``
    (``models/icp.py::drive_chunks``)."""
    targets, normals, config = consts
    points, rot, trans, prev_error, done, num_iterations = state
    nan = torch.full((), float("nan"), device=points.device)
    rows = []
    for _ in range(k):
        new_points, inc, error, frac = _iteration(points, targets, normals,
                                                  config)
        active = ~done
        rows.append(torch.where(active, torch.stack([
            error, torch.broadcast_to(frac, error.shape),
            torch.linalg.vector_norm(inc.translation, dim=-1),
            rotation_angle(inc.rotation)]), nan))
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
    return (_BatchState(points, rot, trans, prev_error, done, num_iterations),
            torch.stack(rows))


def _batched_loop(sources, targets, normals, config: ICPConfig) -> ICPResult:
    b, device = sources.shape[0], sources.device
    state = _BatchState(
        sources, torch.eye(3, device=device).expand(b, 3, 3).contiguous(),
        torch.zeros((b, 3), device=device),
        torch.full((b,), float("inf"), device=device),
        torch.zeros(b, dtype=torch.bool, device=device),
        torch.zeros(b, dtype=torch.int32, device=device))
    # the chunk never reads max_iterations: one graph serves every length
    consts = (targets, normals, dataclasses.replace(config, max_iterations=0))
    state, rows = drive_chunks(_batch_chunk, state, consts,
                               config.max_iterations,
                               lambda st: bool(st.done.all()), (4, b))
    # [B, max_iterations] each, NaN after the stop
    errors, fractions, delta_t, delta_rot = rows.permute(1, 2, 0).contiguous()
    return ICPResult(transform=RigidTransform(state.rotation,
                                              state.translation),
                     errors=errors, num_iterations=state.num_iterations,
                     converged=state.done, points=state.points,
                     matched_fraction=fractions, delta_t=delta_t,
                     delta_rot=delta_rot)


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
