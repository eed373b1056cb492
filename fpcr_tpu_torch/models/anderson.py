"""AA-ICP: Anderson-accelerated ICP (Pavlov et al., arXiv:1709.05479).

Counterpart of ``fpcr_tpu/models/anderson.py``. ICP is a fixed-point
iteration ``T <- g(T)`` on SE(3); Anderson acceleration extrapolates from
the last ``m`` iterates. The transform is the 6-vector ``x = [log R, t]``,
the history of ``m`` (iterate, residual) pairs lives in fixed-size device
buffers, and the mixing coefficients come from a regularised ``m x m``
solve (``torch.linalg.solve_ex``, whose status stays on the device).

Safeguard (the paper's): both the accelerated candidate and the plain step
are scored alike, by the RMSE of fresh matches at each pose under the same
trimming and weights, and the candidate is kept only where it is lower, a
device ``torch.where``; on a rejection the history restarts from the plain
step's pair. An iteration therefore matches three times: the plain step and
the two scores (kernel K1 three times on a CUDA tensor with the brute
matcher). The loop is ``models/icp.py``'s: masked device state, ``done``
read once per ``DONE_CHECK_EVERY`` iterations, chunks of those iterations
captured as CUDA graphs on the card (the chunk body :func:`_aa_chunk` and
its two steps are module functions of the loop's constants, so the graph
cache's key repeats from call to call).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.metrics import rmse
from ..core.transforms import transform_to_vector, vector_to_transform
from ..utils.precision import pin_f32_precision
from .icp import (ICPConfig, ICPResult, _correspondences, _prepare,
                  correspondence_weights, drive_chunks, icp_iteration,
                  rotation_angle)

# the ridge of the mixing system
REG = 1e-10


def _aa_mix(hist_x: torch.Tensor, hist_f: torch.Tensor,
            hist_len: torch.Tensor, x_new: torch.Tensor,
            f_new: torch.Tensor, reg: float) -> torch.Tensor:
    """Type-II Anderson mixing over the valid history rows."""
    m = hist_x.shape[0]
    dF = f_new[None, :] - hist_f  # [m, 6], against the newest pair
    dX = x_new[None, :] - hist_x
    valid = (torch.arange(m, device=hist_x.device) < hist_len)[:, None]
    dFv = dF * valid.to(dF.dtype)
    G = (torch.matmul(dFv, dFv.T)
         + reg * torch.eye(m, dtype=dF.dtype, device=dF.device))
    gamma = torch.linalg.solve_ex(G, torch.matmul(dFv, f_new))[0]
    gamma = gamma * valid[:, 0].to(gamma.dtype)
    # accelerated iterate: g(x) - Σ gamma_j (dX_j + dF_j)
    return (x_new + f_new) - torch.matmul(gamma, dX + dF)


class _AAConsts(NamedTuple):
    """What no iteration changes: the prepared clouds, normals and matcher
    state, and the frozen config."""

    source: torch.Tensor
    target: torch.Tensor
    target_mask: Optional[torch.Tensor]
    target_normals: Optional[torch.Tensor]
    source_normals: Optional[torch.Tensor]  # symmetric and gicp only
    matcher_state: object
    config: ICPConfig


class _AAState(NamedTuple):
    """The loop state, every field on the device."""

    x: torch.Tensor  # [6] the accumulated estimate [log R, t]
    hist_x: torch.Tensor  # [m, 6] iterates, newest first
    hist_f: torch.Tensor  # [m, 6] residuals g(x) - x
    hist_len: torch.Tensor
    prev_error: torch.Tensor
    done: torch.Tensor
    num_iterations: torch.Tensor


def _eval_error(xvec: torch.Tensor, c: _AAConsts) -> torch.Tensor:
    """RMSE of fresh matches at the pose ``xvec``, trimmed and weighted as
    ``icp_iteration``'s error: a like-for-like safeguard."""
    points = vector_to_transform(xvec).apply(c.source)
    q_m, _, dmin, found = _correspondences(
        points, c.target, c.target_mask, c.target_normals, c.config,
        c.matcher_state)
    return rmse(points, q_m, correspondence_weights(dmin, found, c.config))


def _plain_step(xvec: torch.Tensor, c: _AAConsts):
    """One ICP iteration from the accumulated ``xvec``: ``(g(x), aux)``."""
    pose = vector_to_transform(xvec)
    normals = (None if c.source_normals is None
               else torch.matmul(c.source_normals, pose.rotation.T))
    _, inc, _, aux = icp_iteration(
        pose.apply(c.source), c.target, c.config, target_mask=c.target_mask,
        target_normals=c.target_normals, matcher_state=c.matcher_state,
        source_normals=normals)
    return transform_to_vector(inc.compose(pose)), aux


def _aa_chunk(state: _AAState, c: _AAConsts, k: int):
    """``k`` masked AA-ICP iterations from ``state``: ``(state, rows [k,
    5])``, a row an iteration holding its error, matched fraction, ‖Δt‖,
    ∠ΔR (NaN where the loop had stopped) and whether it kept the Anderson
    candidate (1 or 0). A pure function of its tensors: on the card one
    CUDA graph a ``k`` (``models/icp.py::drive_chunks``)."""
    x, hist_x, hist_f, hist_len, prev_error, done, n_it = state
    history = hist_x.shape[0]
    nan = torch.full((), float("nan"), dtype=torch.float32, device=x.device)
    rows = []
    for _ in range(k):
        gx, aux = _plain_step(x, c)
        f = gx - x
        x_acc = _aa_mix(hist_x, hist_f, hist_len, x, f, reg=REG)
        err_acc = _eval_error(x_acc, c)
        err_plain = _eval_error(gx, c)
        use_acc = (hist_len > 0) & (err_acc < err_plain)
        x_next = torch.where(use_acc, x_acc, gx)
        err = torch.where(use_acc, err_acc, err_plain)
        rel = vector_to_transform(x_next).compose(
            vector_to_transform(x).inverse())
        converged = (err < c.config.tolerance) | (
            torch.abs(err - prev_error) < c.config.tolerance)
        active = ~done
        rows.append(torch.stack([
            torch.where(active, err, nan),
            torch.where(active, aux.matched_fraction, nan),
            torch.where(active, torch.linalg.vector_norm(rel.translation),
                        nan),
            torch.where(active, rotation_angle(rel.rotation), nan),
            (active & use_acc).to(torch.float32)]))
        # push (x, f) into the history ring; a rejected candidate restarts
        # the history (Pavlov et al. §III.B): only the pair just pushed
        # stays valid
        hist_x = torch.where(active, torch.cat([x[None], hist_x[:-1]]),
                             hist_x)
        hist_f = torch.where(active, torch.cat([f[None], hist_f[:-1]]),
                             hist_f)
        hist_len = torch.where(
            active, torch.where(use_acc, torch.clamp(hist_len + 1,
                                                     max=history),
                                torch.ones_like(hist_len)), hist_len)
        x = torch.where(active, x_next, x)
        prev_error = torch.where(active, err, prev_error)
        n_it = n_it + active.to(torch.int32)
        done = done | (active & converged)
    return (_AAState(x, hist_x, hist_f, hist_len, prev_error, done, n_it),
            torch.stack(rows))


def run_aa_icp(source, target, config: ICPConfig = ICPConfig(),
               history: int = 5,
               target_normals: Optional[torch.Tensor] = None,
               target_mask: Optional[torch.Tensor] = None,
               return_accepted: bool = False):
    """Anderson-accelerated registration on the clouds' device, with the
    contract of ``run_icp``: every metric and matcher (the inner step is
    ``icp_iteration``), set up by ``run_icp``'s own ``_prepare``, so a grid
    config above the candidate limit degrades to morton here too. The
    returned points are the source under the
    accumulated estimate. ``return_accepted=True`` returns ``(result,
    accepted)``, ``accepted[i]`` whether iteration i kept the Anderson
    candidate.

    On the card the loop runs as CUDA graphs of ``DONE_CHECK_EVERY``
    iterations (``models/icp.py::drive_chunks``) from the second call of
    its shapes and config on; eagerly on the first, on the CPU and under
    ``graphs.eager()``."""
    pin_f32_precision()
    (source, target, _, target_mask, target_normals, normals0, matcher_state,
     unsort, config) = _prepare(source, target, config,
                                target_mask=target_mask,
                                target_normals=target_normals)
    device = source.device
    f32 = dict(dtype=torch.float32, device=device)
    state = _AAState(
        torch.zeros(6, **f32), torch.zeros((history, 6), **f32),
        torch.zeros((history, 6), **f32),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.full((), float("inf"), **f32),
        torch.zeros((), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device))
    # the chunk never reads max_iterations: one graph serves every length
    consts = _AAConsts(source, target, target_mask, target_normals, normals0,
                       matcher_state,
                       dataclasses.replace(config, max_iterations=0))
    state, rows = drive_chunks(_aa_chunk, state, consts,
                               config.max_iterations,
                               lambda st: bool(st.done), (5,))
    errors, fractions, delta_t, delta_rot, accepted = rows.T.contiguous()
    transform = vector_to_transform(state.x)
    points = transform.apply(source)
    result = ICPResult(
        transform=transform, errors=errors,
        num_iterations=state.num_iterations, converged=state.done,
        points=points if unsort is None else points[unsort],
        matched_fraction=fractions, delta_t=delta_t, delta_rot=delta_rot)
    if not return_accepted:
        return result
    return result, accepted == 1.0
