"""SGD-ICP: stochastic mini-batch ICP (Maken, Ramos & Ott,
arXiv:1907.09133).

Counterpart of ``fpcr_tpu/models/sgd_icp.py``. Each step matches a random
mini-batch of B source points against the whole target (``nn_argmin`` on
``[B, 3]`` rows: kernel K1 on a CUDA tensor) and takes a momentum step on
the point-to-point cost ``E = mean ‖x_i − q_i‖²``. The pose lives on
se(3): the step turns the estimate by ``exp(δω)`` about the source
centroid and shifts it by ``δt``, with the closed-form gradients
``∂E/∂δt = 2·mean(r_i)`` and ``∂E/∂δω = 2·mean((x_i − c) × r_i)``
preconditioned by the diagonal Gauss-Newton scale. The step size anneals as
``lr / (1 + lr_decay·t)``, and convergence is tested on an exponential
moving average of the batch RMSE after a warm-up of 10 steps.

The batches come from a ``torch.Generator`` on the cloud's device, seeded
from ``seed`` and advanced once a step; the JAX package's ``fold_in``
stream cannot be reproduced in torch, so the loop :func:`_sgd_loop` takes
the draw as a callable. The loop is ``models/icp.py``'s: masked device
state, ``done`` read once per ``DONE_CHECK_EVERY`` steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.cloud import as_points
from ..core.transforms import RigidTransform, rotation_exp
from ..ops.matching import gather_correspondences, nn_argmin
from ..utils.precision import pin_f32_precision
from .icp import (DONE_CHECK_EVERY, ICPConfig, ICPResult, _nan_padded,
                  rotation_angle)


def _sgd_loop(source: torch.Tensor, target: torch.Tensor, config: ICPConfig,
              draw: Callable[[int], torch.Tensor], *, batch_size: int,
              learning_rate: float, momentum: float, ema: float,
              lr_decay: float,
              target_mask: Optional[torch.Tensor] = None) -> ICPResult:
    """The SGD-ICP loop on contiguous float32 clouds of one device;
    ``draw(step)`` gives the step's batch rows, int64 ``[batch_size]``."""
    device = source.device
    f32 = dict(dtype=torch.float32, device=device)
    nan = torch.full((), float("nan"), **f32)
    centroid = source.mean(dim=0)
    rotation = torch.eye(3, **f32)
    translation = torch.zeros(3, **f32)
    velocity = torch.zeros(6, **f32)
    ema_error = torch.full((), float("inf"), **f32)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors, delta_t, delta_rot = [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        x = torch.matmul(source[draw(it)], rotation.T) + translation
        q_idx, _ = nn_argmin(x, target, target_mask,
                             source_chunk=min(batch_size, 2048),
                             target_tile=config.target_tile)
        r = x - gather_correspondences(target, q_idx)
        xc = x - centroid
        g_t = 2.0 * r.mean(dim=0)
        g_w = 2.0 * torch.linalg.cross(xc, r).mean(dim=0)
        # diagonal Gauss-Newton preconditioner: H_t ≈ 2I, H_ω ≈ 2·mean|x−c|²
        s_w = 2.0 * torch.sum(xc * xc, dim=1).mean() + 1e-12
        grad = torch.cat([g_w / s_w, g_t / 2.0])
        # float32, as the JAX package computes it
        lr_t = float(np.float32(learning_rate) / (
            np.float32(1.0) + np.float32(lr_decay) * np.float32(it)))
        vel = momentum * velocity - lr_t * grad
        # the centroid-anchored perturbation g(x) = dR·(x − c) + c + δt:
        # R ← dR·R, t ← dR·(t − c) + c + δt
        d_rot = rotation_exp(vel[:3])
        new_r = torch.matmul(d_rot, rotation)
        new_t = (torch.matmul(d_rot, translation - centroid) + centroid
                 + vel[3:])
        batch_rmse = torch.sqrt(torch.sum(r * r, dim=1).mean())
        ema_new = (batch_rmse if it == 0
                   else ema * ema_error + (1.0 - ema) * batch_rmse)
        converged = (torch.zeros((), dtype=torch.bool, device=device)
                     if it <= 10 else  # let the moving average warm up
                     (ema_new < config.tolerance)
                     | (torch.abs(ema_new - ema_error) < config.tolerance))
        active = ~done
        errors.append(torch.where(active, ema_new, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(vel[3:]),
                                   nan))
        delta_rot.append(torch.where(active, rotation_angle(d_rot), nan))
        rotation = torch.where(active, new_r, rotation)
        translation = torch.where(active, new_t, translation)
        velocity = torch.where(active, vel, velocity)
        ema_error = torch.where(active, ema_new, ema_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)
    n = config.max_iterations
    transform = RigidTransform(rotation, translation)
    errs = _nan_padded(errors, n, device)
    return ICPResult(
        transform=transform, errors=errs, num_iterations=num_iterations,
        converged=done, points=transform.apply(source),
        matched_fraction=torch.where(torch.isnan(errs), errs,
                                     torch.ones_like(errs)),
        delta_t=_nan_padded(delta_t, n, device),
        delta_rot=_nan_padded(delta_rot, n, device))


def run_sgd_icp(source, target,
                config: ICPConfig = ICPConfig(max_iterations=200,
                                              tolerance=1e-5),
                batch_size: int = 1024, learning_rate: float = 0.2,
                momentum: float = 0.7, ema: float = 0.9, seed: int = 0,
                lr_decay: float = 0.02,
                target_mask: Optional[torch.Tensor] = None) -> ICPResult:
    """Register ``source`` onto ``target`` by stochastic mini-batch steps
    on their device. The result contract is ``run_icp``'s; ``errors`` holds
    the moving average of the batch RMSE and ``matched_fraction`` is 1 (no
    trimming on this path; polish with ``run_icp`` where that is needed).
    Gradients are in cost units: scale ``learning_rate`` down for clouds
    with very large coordinates."""
    pin_f32_precision()
    source = as_points(source).contiguous()
    device = source.device
    target = as_points(target, device=device).contiguous()
    if target_mask is not None:
        target_mask = target_mask.to(device).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = source.shape[0]

    def draw(_step):
        return torch.randint(0, n, (batch_size,), generator=gen,
                             device=device)

    return _sgd_loop(source, target, config, draw, batch_size=batch_size,
                     learning_rate=learning_rate, momentum=momentum, ema=ema,
                     lr_decay=lr_decay, target_mask=target_mask)
