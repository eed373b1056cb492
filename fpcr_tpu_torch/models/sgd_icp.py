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
the draw as a callable. The batches of all ``max_iterations`` steps are
drawn before the loop into one ``[max_iterations, batch]`` table, which the
loop reads by a device step counter, as it computes the step size and the
warm-up from it: a step is then a pure function of device tensors. The loop
is ``models/icp.py``'s: masked device state, ``done`` read once per
``DONE_CHECK_EVERY`` steps, chunks of those steps captured as CUDA graphs
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..core.cloud import as_points
from ..core.transforms import RigidTransform, rotation_exp
from ..ops.matching import gather_correspondences, nn_argmin
from ..utils.precision import pin_f32_precision
from .icp import ICPConfig, ICPResult, drive_chunks, rotation_angle


class _SGDState(NamedTuple):
    """The loop state, every field on the device."""

    rotation: torch.Tensor
    translation: torch.Tensor
    velocity: torch.Tensor  # [6] momentum, [δω, δt]
    ema_error: torch.Tensor
    done: torch.Tensor
    num_iterations: torch.Tensor
    step: torch.Tensor  # int32: the loop index, counted after the stop too


class _SGDConsts(NamedTuple):
    source: torch.Tensor
    target: torch.Tensor
    target_mask: Optional[torch.Tensor]
    rows: torch.Tensor  # int64 [max_iterations, batch]: each step's batch
    centroid: torch.Tensor
    config: ICPConfig  # max_iterations zeroed
    # (learning_rate, momentum, ema, lr_decay)
    rates: tuple


def _sgd_chunk(state: _SGDState, c: _SGDConsts, k: int):
    """``k`` masked SGD steps from ``state``: ``(state, rows [k, 3])``, a
    row a step holding the moving average of the batch RMSE, ‖δt‖ and
    ∠δR, NaN where the loop had stopped. The step's batch is row ``step``
    of ``c.rows``, read on the device. A pure function of its tensors: on
    the card one CUDA graph a ``k`` (``models/icp.py::drive_chunks``)."""
    learning_rate, momentum, ema, lr_decay = c.rates
    rotation, translation, velocity, ema_error, done, n_it, step = state
    device = rotation.device
    nan = torch.full((), float("nan"), dtype=torch.float32, device=device)
    lr = torch.full((), learning_rate, dtype=torch.float32, device=device)
    decay = torch.full((), lr_decay, dtype=torch.float32, device=device)
    batch_size = c.rows.shape[1]
    rows = []
    for _ in range(k):
        batch = torch.index_select(c.rows, 0, step.long().reshape(1))[0]
        x = (torch.matmul(torch.index_select(c.source, 0, batch),
                          rotation.T) + translation)
        q_idx, _ = nn_argmin(x, c.target, c.target_mask,
                             source_chunk=min(batch_size, 2048),
                             target_tile=c.config.target_tile)
        r = x - gather_correspondences(c.target, q_idx)
        xc = x - c.centroid
        g_t = 2.0 * r.mean(dim=0)
        g_w = 2.0 * torch.linalg.cross(xc, r).mean(dim=0)
        # diagonal Gauss-Newton preconditioner: H_t ≈ 2I, H_ω ≈ 2·mean|x−c|²
        s_w = 2.0 * torch.sum(xc * xc, dim=1).mean() + 1e-12
        grad = torch.cat([g_w / s_w, g_t / 2.0])
        # float32, as the JAX package computes it
        lr_t = lr / (1.0 + decay * step.to(torch.float32))
        vel = momentum * velocity - lr_t * grad
        # the centroid-anchored perturbation g(x) = dR·(x − c) + c + δt:
        # R ← dR·R, t ← dR·(t − c) + c + δt
        d_rot = rotation_exp(vel[:3])
        new_r = torch.matmul(d_rot, rotation)
        new_t = (torch.matmul(d_rot, translation - c.centroid) + c.centroid
                 + vel[3:])
        batch_rmse = torch.sqrt(torch.sum(r * r, dim=1).mean())
        ema_new = torch.where(step == 0, batch_rmse,
                              ema * ema_error + (1.0 - ema) * batch_rmse)
        # the moving average warms up for 10 steps
        converged = (step > 10) & (
            (ema_new < c.config.tolerance)
            | (torch.abs(ema_new - ema_error) < c.config.tolerance))
        active = ~done
        rows.append(torch.stack([
            torch.where(active, ema_new, nan),
            torch.where(active, torch.linalg.vector_norm(vel[3:]), nan),
            torch.where(active, rotation_angle(d_rot), nan)]))
        rotation = torch.where(active, new_r, rotation)
        translation = torch.where(active, new_t, translation)
        velocity = torch.where(active, vel, velocity)
        ema_error = torch.where(active, ema_new, ema_error)
        n_it = n_it + active.to(torch.int32)
        done = done | (active & converged)
        step = step + 1
    return (_SGDState(rotation, translation, velocity, ema_error, done, n_it,
                      step), torch.stack(rows))


def _sgd_loop(source: torch.Tensor, target: torch.Tensor, config: ICPConfig,
              draw: Callable[[int], torch.Tensor], *, batch_size: int,
              learning_rate: float, momentum: float, ema: float,
              lr_decay: float,
              target_mask: Optional[torch.Tensor] = None) -> ICPResult:
    """The SGD-ICP loop on contiguous float32 clouds of one device;
    ``draw(step)`` gives the step's batch rows, int64 ``[batch_size]``,
    drawn for every step before the loop, in step order.

    On the card the loop runs as CUDA graphs of ``DONE_CHECK_EVERY``
    steps (``models/icp.py::drive_chunks``) from the second call of its
    shapes and config on; eagerly on the first, on the CPU and under
    ``graphs.eager()``."""
    device = source.device
    f32 = dict(dtype=torch.float32, device=device)
    n = config.max_iterations
    rows = (torch.stack([draw(it).to(device=device, dtype=torch.int64)
                         for it in range(n)]) if n else
            torch.zeros((0, batch_size), dtype=torch.int64, device=device))
    state = _SGDState(
        torch.eye(3, **f32), torch.zeros(3, **f32), torch.zeros(6, **f32),
        torch.full((), float("inf"), **f32),
        torch.zeros((), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))
    consts = _SGDConsts(source, target, target_mask, rows.contiguous(),
                        source.mean(dim=0),
                        dataclasses.replace(config, max_iterations=0),
                        (float(learning_rate), float(momentum), float(ema),
                         float(lr_decay)))
    state, out = drive_chunks(_sgd_chunk, state, consts, n,
                              lambda st: bool(st.done), (3,))
    errs, delta_t, delta_rot = out.T.contiguous()
    transform = RigidTransform(state.rotation, state.translation)
    return ICPResult(
        transform=transform, errors=errs,
        num_iterations=state.num_iterations, converged=state.done,
        points=transform.apply(source),
        matched_fraction=torch.where(torch.isnan(errs), errs,
                                     torch.ones_like(errs)),
        delta_t=delta_t, delta_rot=delta_rot)


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
