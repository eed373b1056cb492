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
read once per ``DONE_CHECK_EVERY`` iterations.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.metrics import rmse
from ..core.transforms import transform_to_vector, vector_to_transform
from ..utils.precision import pin_f32_precision
from .icp import (DONE_CHECK_EVERY, ICPConfig, ICPResult, _correspondences,
                  _nan_padded, _prepare, correspondence_weights,
                  icp_iteration, rotation_angle)


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
    candidate."""
    pin_f32_precision()
    (source, target, _, target_mask, target_normals, normals0, matcher_state,
     unsort, config) = _prepare(source, target, config,
                                target_mask=target_mask,
                                target_normals=target_normals)
    device = source.device

    def eval_error(xvec):
        """RMSE of fresh matches at the pose ``xvec``, trimmed and weighted
        as ``icp_iteration``'s error: a like-for-like safeguard."""
        points = vector_to_transform(xvec).apply(source)
        q_m, _, dmin, found = _correspondences(
            points, target, target_mask, target_normals, config,
            matcher_state)
        return rmse(points, q_m, correspondence_weights(dmin, found, config))

    def plain_step(xvec):
        """One ICP iteration from the accumulated ``xvec``: g(x)."""
        pose = vector_to_transform(xvec)
        normals = (None if normals0 is None
                   else torch.matmul(normals0, pose.rotation.T))
        _, inc, _, aux = icp_iteration(
            pose.apply(source), target, config, target_mask=target_mask,
            target_normals=target_normals, matcher_state=matcher_state,
            source_normals=normals)
        return transform_to_vector(inc.compose(pose)), aux

    f32 = dict(dtype=torch.float32, device=device)
    nan = torch.full((), float("nan"), **f32)
    x = torch.zeros(6, **f32)
    hist_x = torch.zeros((history, 6), **f32)
    hist_f = torch.zeros((history, 6), **f32)
    hist_len = torch.zeros((), dtype=torch.int32, device=device)
    prev_error = torch.full((), float("inf"), **f32)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors, fractions, delta_t, delta_rot, accepted = [], [], [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        gx, aux = plain_step(x)
        f = gx - x
        x_acc = _aa_mix(hist_x, hist_f, hist_len, x, f, reg=1e-10)
        err_acc = eval_error(x_acc)
        err_plain = eval_error(gx)
        use_acc = (hist_len > 0) & (err_acc < err_plain)
        x_next = torch.where(use_acc, x_acc, gx)
        err = torch.where(use_acc, err_acc, err_plain)
        rel = vector_to_transform(x_next).compose(
            vector_to_transform(x).inverse())
        converged = (err < config.tolerance) | (
            torch.abs(err - prev_error) < config.tolerance)
        active = ~done
        errors.append(torch.where(active, err, nan))
        fractions.append(torch.where(active, aux.matched_fraction, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(
            rel.translation), nan))
        delta_rot.append(torch.where(active, rotation_angle(rel.rotation),
                                     nan))
        accepted.append(active & use_acc)
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
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)

    n = config.max_iterations
    transform = vector_to_transform(x)
    points = transform.apply(source)
    result = ICPResult(
        transform=transform, errors=_nan_padded(errors, n, device),
        num_iterations=num_iterations, converged=done,
        points=points if unsort is None else points[unsort],
        matched_fraction=_nan_padded(fractions, n, device),
        delta_t=_nan_padded(delta_t, n, device),
        delta_rot=_nan_padded(delta_rot, n, device))
    if not return_accepted:
        return result
    flags = torch.zeros(n, dtype=torch.bool, device=device)
    if accepted:
        flags[:len(accepted)] = torch.stack(accepted)
    return result, flags
