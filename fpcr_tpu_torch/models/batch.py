"""Batched registration: many cloud pairs in one loop on the device.

Counterpart of ``fpcr_tpu/models/batch.py``. :func:`register_batch`
registers ``sources[b]`` onto ``targets[b]`` for every b and returns an
``ICPResult`` whose fields carry a leading batch axis, each element's values
those of its own ``run_icp``: the serving path (B scenes a request), and the
engine of odometry and loop-closure verification.

The JAX package ``vmap``s its whole loop, for every ``ICPConfig``, and
``vmap`` adds a batch axis to the grid of each Pallas kernel the loop
reaches. Here the batch axis is written out, for every config as well:
``models/icp.py``'s set-up, iteration and chunk take ``[B, ...]`` tensors,
so the state of all B elements (points, carried source normals, transform,
previous error, done flag, iteration count) lives in ``[B, ...]`` tensors
and each iteration makes one batched matcher call for the whole batch:

* the brute matcher (``matcher`` 'xla' or 'pallas'): on the card one
  launch pair of K1 (K2 under ``pallas_mode='packed6_idx'``), the element
  on ``blockIdx.z``;
* the morton matcher: one launch of K3 (K3p) a shift, the element on
  ``blockIdx.z`` with its own stacked Morton table, band bases and culling
  (``ops/morton_cuda.py``), and ``morton_rescue`` through one batched K1
  call; each source is sorted along its own target's curve once and the
  points come back in the caller's row order;
* the grid matcher: each element's voxel table and suggested cell size,
  stacked, and one ``grid_nn`` pass (plain torch, as the JAX package
  computes it in XLA); the degrade to morton is decided once for the
  batch's N;
* the plane, symmetric and GICP metrics: the normals prepass of every
  target (and source) in one pass (``ops/normals.py``; above
  ``normals_banded_threshold`` the banded search runs element by element),
  the symmetric solve on ``n_p + sign·n_q`` and GICP's Woodbury normal
  equations and 6x6 ``cholesky_ex`` along the batch axis.

An element that has converged is a masked no-op, as under ``vmap``; the host
reads the ``done`` flags once per ``DONE_CHECK_EVERY`` iterations, as
``run_icp`` does, and stops when every element is done. In a captured
chunk an iteration that starts with every element done runs none of its
kernels. On the card those
iterations are one replay of a CUDA graph from the second call of the
batch's shapes and config on, as ``run_icp``'s are
(``models/icp.py::drive_chunks``; the JAX package's loop is one ``jit``);
the stacked tables and normals are copied into the graph's buffers once a
call, as the other loops' constants are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.transforms import RigidTransform
from ..ops.matching import gather_correspondences
from ..utils import timing
from ..utils.device import resolve_device
from ..utils.precision import pin_f32_precision
from .icp import (ICPConfig, ICPResult, _ICPState, _icp_chunk, _prepare,
                  count_k1_rescued, drive_chunks, rescued_mark)


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


def _first_state(sources, source_normals) -> _ICPState:
    """The loop's state before its first iteration: every element at the
    identity, nothing done."""
    b, device = sources.shape[0], sources.device
    return _ICPState(
        sources, source_normals,
        torch.eye(3, device=device).expand(b, 3, 3).contiguous(),
        torch.zeros((b, 3), device=device),
        torch.full((b,), float("inf"), device=device),
        torch.zeros(b, dtype=torch.bool, device=device),
        torch.zeros(b, dtype=torch.int32, device=device))


def _batched_loop(sources, targets, target_normals, config: ICPConfig,
                  source_normals: Optional[torch.Tensor] = None,
                  matcher_state=None, state: Optional[_ICPState] = None,
                  unsort: Optional[torch.Tensor] = None) -> ICPResult:
    """The loop of every element on prepared inputs (:func:`_prepare` with
    ``batched``: the morton sources in their curve order, whose ``points``
    come back in that order unless ``unsort`` is given), from ``state``
    (:func:`_first_state` where None). The span ``result`` runs from the
    loop's end to the returned ``ICPResult``."""
    if state is None:
        state = _first_state(sources, source_normals)
    # the chunk never reads max_iterations: one graph serves every length
    consts = (targets, None, None, target_normals, matcher_state,
              dataclasses.replace(config, max_iterations=0), None)
    state, rows = drive_chunks(_icp_chunk, state, consts,
                               config.max_iterations,
                               lambda st: bool(st.done.all()),
                               (4, sources.shape[0]))
    span = timing.begin("result")
    # [B, max_iterations] each, NaN after the stop
    errors, fractions, delta_t, delta_rot = rows.permute(1, 2, 0).contiguous()
    result = ICPResult(
        transform=RigidTransform(state.rotation, state.translation),
        errors=errors, num_iterations=state.num_iterations,
        converged=state.done,
        points=(state.points if unsort is None
                else gather_correspondences(state.points, unsort)),
        matched_fraction=fractions, delta_t=delta_t, delta_rot=delta_rot)
    if span:
        span.end()
    return result


def register_batch(sources, targets, config: ICPConfig = ICPConfig(),
                   target_normals: Optional[torch.Tensor] = None
                   ) -> ICPResult:
    """Register ``sources[b]`` onto ``targets[b]`` for every b, on the
    sources' device, as one batched loop whatever the config.

    Args:
      sources: ``[B, N, 3]``; targets: ``[B, M, 3]``;
      target_normals: optional ``[B, M, 3]`` (the plane, symmetric and gicp
        metrics estimate them, for the whole batch in one pass, when not
        given; the last two estimate the sources' normals too).

    Returns an ``ICPResult`` whose fields carry the leading batch axis:
    ``transform`` holds rotations ``[B, 3, 3]`` and translations ``[B, 3]``,
    the per-iteration rows are ``[B, max_iterations]``, ``points`` is in
    the caller's row order.

    Recorded (``utils/timing.py``), a call is the root span ``call`` over
    ``prepare`` (the checks, :func:`_prepare` and the loop's first state),
    ``models/icp.py::drive_chunks``' spans and ``result``, and counts
    ``k1_rescued`` (``models/icp.py::count_k1_rescued``).
    """
    with timing.call("register_batch") as call:
        span = timing.begin("prepare")
        pin_f32_precision()
        sources = _as_batch(sources, "sources")
        targets = _as_batch(targets, "targets", device=sources.device)
        if targets.shape[0] != sources.shape[0]:
            raise ValueError(f"{sources.shape[0]} sources but "
                             f"{targets.shape[0]} targets")
        if target_normals is not None:
            target_normals = _as_batch(target_normals, "target_normals",
                                       device=sources.device)
        prep = _prepare(sources, targets, config,
                        target_normals=target_normals, batched=True)
        state = _first_state(prep.source, prep.source_normals)
        mark = rescued_mark(call, sources.device)
        if span:
            span.end()
        if call:
            call.attrs.update(B=sources.shape[0], N=sources.shape[1],
                              M=targets.shape[1], metric=prep.config.metric,
                              matcher=prep.config.matcher)
        result = _batched_loop(prep.source, prep.target,
                               prep.target_normals, prep.config,
                               prep.source_normals, prep.matcher_state,
                               state, prep.unsort)
        count_k1_rescued(call, sources.device, mark)
        return result
